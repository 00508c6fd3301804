"""Model FLOPs of a step or an image, from the configuration's shapes.

Counts the multiply-adds (2 FLOPs each) of the matrix products and
convolutions of the ResNet encoder, the ResnetFC field (with NOVEL_PE's
deformation layer) and the VGG19 of the perceptual loss. A training step
counts trained layers three times (forward, input gradient, weight
gradient) and the frozen VGG three times as one forward (the prediction's
forward and input gradient, the target's forward). Nothing is counted for
recomputation, elementwise work, the sampler or the compositing; the
count is the same whatever implements the work.
"""

from __future__ import annotations

STAGE_BLOCKS = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3)}
STAGE_WIDTHS = (64, 128, 256, 512)
# (output channels, pooled before) of VGG19's convolutions up to the last
# feature slice
VGG19_CONVS = ((64, False), (64, False), (128, True), (128, False),
               (256, True), (256, False), (256, False), (256, False),
               (512, True))


def conv_out(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


def conv(cin, cout, k, h, w) -> int:
    """FLOPs of one convolution with an ``h``×``w`` output."""
    return 2 * k * k * cin * cout * h * w


def pe_width(num_freqs: int, d_in: int, include_input: bool = True) -> int:
    return num_freqs * 2 * d_in + (d_in if include_input else 0)


def encoder(c: dict) -> int:
    """Forward FLOPs of the spatial encoder for one image."""
    e = c["encoder"]
    H, W = (s + 2 * e["image_padding"] for s in c["image_hw"])
    cin = 3 + (pe_width(e["padding_pe"], 2)
               if e["padding_pe"] >= 0 and e["image_padding"] > 0 else 0)
    h, w = conv_out(H, 7, 2, 3), conv_out(W, 7, 2, 3)
    total = conv(cin, 64, 7, h, w)
    cin = 64
    for stage in range(min(e["num_layers"] - 1, 4)):
        if stage == 0 and e["use_first_pool"]:
            h, w = conv_out(h, 3, 2, 1), conv_out(w, 3, 2, 1)
        width = STAGE_WIDTHS[stage]
        for blk in range(STAGE_BLOCKS[e["backbone"]][stage]):
            stride = 2 if (stage > 0 and blk == 0) else 1
            h, w = conv_out(h, 3, stride, 1), conv_out(w, 3, stride, 1)
            total += conv(cin, width, 3, h, w) + conv(width, width, 3, h, w)
            if stride != 1 or cin != width:
                total += conv(cin, width, 1, h, w)
            cin = width
    return total


def latent_width(c: dict) -> int:
    return [0, 64, 128, 256, 512, 1024][c["encoder"]["num_layers"]]


def field_per_point(c: dict) -> int:
    """Forward FLOPs of the field at one sample point, over its views."""
    nv, d, dl = c["source_views"], c["d_hidden"], latent_width(c)
    d_in = (pe_width(c["num_freqs"], 3, c["include_input"])
            + pe_width(c["num_freqs"], 1, c["include_input"]) + 3)
    n_z = min(c["combine_layer"], c["n_blocks"])
    per_view = 2 * d_in * d + n_z * 2 * dl * d
    per_view += min(c["combine_layer"], c["n_blocks"]) * 2 * (2 * d * d)
    if c.get("use_pe_maps"):
        per_view += 2 * (dl + 6) * dl
    after = max(c["n_blocks"] - c["combine_layer"], 0) * 2 * (2 * d * d)
    return nv * per_view + after + 2 * d * 4


def vgg(size: int) -> int:
    """Forward FLOPs of VGG19's convolutions on one ``size``² image."""
    total, cin, s = 0, 3, size
    for cout, pooled in VGG19_CONVS:
        if pooled:
            s //= 2
        total += conv(cin, cout, 3, s, s)
        cin = cout
    return total


def train_step(c: dict) -> int:
    m = c["train"]
    SB, nv = m["scenes_per_step"], c["source_views"]
    rays = m["vgg_spatch"] ** 2 if m["w_vgg"] else m["ray_batch_size"]
    points = SB * rays * m["renderer"]["n_samples"]
    total = SB * nv * encoder(c) + points * field_per_point(c)
    if m["w_vgg"]:
        total += SB * vgg(m["vgg_spatch"])
    return 3 * total


def image(c: dict) -> int:
    H, W = c["image_hw"]
    points = H * W * c["render"]["renderer"]["n_samples"]
    return c["source_views"] * encoder(c) + points * field_per_point(c)
