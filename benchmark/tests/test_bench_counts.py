"""The FLOP and byte counters against hand counts at one small shape."""

from benchmark import flops, harness
from benchmark.kernels import composite, knn, row_gather

PEAKS = {"hbm_bytes_per_s": 1.0, "flops_per_s": {"float32": 1e30}}
SMALL = dict(family="diner", image_hw=[16, 24], source_views=2,
             encoder=dict(backbone="resnet18", num_layers=2,
                          use_first_pool=True, image_padding=4,
                          padding_pe=1),
             num_freqs=1, include_input=True, n_blocks=2, d_hidden=8,
             combine_layer=1, compute_dtype="bfloat16",
             train=dict(scenes_per_step=2, w_vgg=0.1, vgg_spatch=8,
                        renderer=dict(n_samples=3, n_depth_candidates=5)),
             render=dict(renderer=dict(n_samples=4, n_depth_candidates=5)))


def test_encoder_by_hand():
    # 24x32 padded input with 3 + 6 channels; conv1 7x7/2 → 12x16; pool
    # → 6x8; one stage of two basic blocks 64→64 (no downsample)
    conv1 = 2 * 49 * 9 * 64 * 12 * 16
    stage = 4 * 2 * 9 * 64 * 64 * 6 * 8
    assert flops.encoder(SMALL) == conv1 + stage


def test_field_by_hand():
    # d_in = (3 + 6) + (1 + 2) + 3 = 15; latent 64 + 64 = 128; hidden 8;
    # per view lin_in, one lin_z, one block (2 dense); after the mean one
    # block and lin_out
    per_view = 2 * 15 * 8 + 2 * 128 * 8 + 2 * (2 * 8 * 8)
    after = 2 * (2 * 8 * 8) + 2 * 8 * 4
    assert flops.field_per_point(SMALL) == 2 * per_view + after


def test_vgg_and_step_by_hand():
    v = (2 * 9 * 3 * 64 * 64 + 2 * 9 * 64 * 64 * 64
         + 2 * 9 * (64 * 128 + 128 * 128) * 16
         + 2 * 9 * (128 * 256 + 3 * 256 * 256) * 4
         + 2 * 9 * 256 * 512 * 1)
    assert flops.vgg(8) == v
    points = 2 * 64 * 3
    assert flops.train_step(SMALL) == 3 * (
        4 * flops.encoder(SMALL) + points * flops.field_per_point(SMALL)
        + 2 * v)
    assert flops.image(SMALL) == (2 * flops.encoder(SMALL) + 16 * 24 * 4
                                  * flops.field_per_point(SMALL))


def test_composite_bytes_by_hand():
    # R = 2 rays, K = 3: forward reads 2·3·5 + 2 floats, writes 2·3 + 2
    # + 2·3; backward reads 2·3·5 + 2·4, writes 2·3·4
    assert composite.forward_s(2, 3, PEAKS) == 4 * (30 + 2 + 6 + 2 + 6)
    assert composite.backward_s(2, 3, PEAKS) == 4 * (30 + 8 + 24)
    train = composite.bound_s(SMALL, "train", PEAKS)
    assert train == (composite.forward_s(128, 3, PEAKS)
                     + composite.backward_s(128, 3, PEAKS))


def test_gather_bytes_by_hand():
    # 2 scenes x 64 rays: the map at 2·2·64·5 candidates (20 B), the depth
    # and 4 bf16 latent corners (128·2 B) at 2·2·64·3 samples; 8-byte
    # indices
    rows_map, rows_s = 2 * 2 * 64 * 5, 2 * 2 * 64 * 3
    want = rows_map * 28 + rows_s * 12 + 4 * rows_s * (256 + 8)
    assert row_gather.bound_s(SMALL, "train", PEAKS) == want


def test_knn_bytes_by_hand():
    peaks = dict(PEAKS, flops_per_s={"float32": 1e30})
    assert knn.search_s(1, 10, 7, peaks) == 10 * 16 + 7 * 12
    c = dict(SMALL, mesh_vertices=7)
    assert knn.bound_s(c, "train", peaks) == (
        2 * (64 * 5 * 16 + 84) + 2 * 2 * (64 * 3 * 16 + 84))


def test_seeds_split_into_streams():
    s = 2 ** 31 + 5
    assert len({harness.sub_seed(s, k) for k in range(200)}) == 200
    assert harness.sub_seed(s, 1) == harness.sub_seed(s, 1)
