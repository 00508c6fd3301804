"""TransMVSNet in bf16: the port against the JAX package on the CPU.

The JAX package's own bf16 test (``tests/test_mvs.py:320``) asks only for
finite depth. Here both packages' bf16 models take the train-mode forward
of ``tests/test_torch_mvs_train.py``'s toy batch from the same seeded
variables.
bf16 keeps 8 bits, and the two frameworks round convolutions, softmax and
sums at other places, so the check is relative to f32: the port's bf16
stage-1 probabilities may be no further from the f32 forward than
``BF16_VS_JAX`` times the JAX bf16 forward's distance (plus one bf16 step
at 1, 2^-8), and within ``BF16_PROB_ATOL`` of the JAX bf16 forward; the
loss within ``BF16_LOSS_RTOL``. The f32 parameters' gradients must be
finite and the parameters stay f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diner_tpu.mvs import loss as jloss
from diner_tpu.mvs.model import TransMVSNet as JTransMVSNet
from diner_tpu.mvs.model import TransMVSNetConfig as JConfig
from diner_tpu_torch.mvs import loss, train
from diner_tpu_torch.mvs.model import TransMVSNetConfig
from tests.test_torch_mvs_train import (
    TOY,
    _jax_batch,
    _port_state_dict,
    jax_variables,
    toy_batch,
)
from tests.torch_mvs_tol import BF16_LOSS_RTOL, BF16_PROB_ATOL, BF16_VS_JAX

DLOSSW = (0.5, 1.0, 2.0)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads while this module runs: the suite runs several
    workers at once on the host's cores, and more torch threads than cores
    make every op wait on the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_bf16_forward_matches_jax():
    batch = toy_batch(6)
    jb = _jax_batch(batch)
    jm = JTransMVSNet(cfg=JConfig(**TOY), dtype=jnp.bfloat16)
    variables = jax_variables(jm, batch, seed=1)
    jout, _ = jax.jit(lambda v, b: jm.apply(
        v, b["imgs"], b["proj_matrices"], b["depth_values"], train=True,
        mutable=["batch_stats"]))(variables, jb)
    jl = jloss.trans_mvsnet_loss(jout, jb["depth"], jb["mask"], DLOSSW)[0]
    sd = _port_state_dict({"params": variables["params"],
                           "batch_stats": variables["batch_stats"]})
    b = train.batch_to_device(batch, "cpu")
    outs, losses = {}, {}
    for dtype in ("float32", "bfloat16"):
        st = train.create_mvs_state(
            train.MVSTrainConfig(model=TransMVSNetConfig(**TOY),
                                 compute_dtype=dtype), device="cpu")
        st.model.load_state_dict(sd)
        out = st.model.train()(b["imgs"], b["proj_matrices"],
                               b["depth_values"])
        total = loss.trans_mvsnet_loss(out, b["depth"], b["mask"], DLOSSW)[0]
        outs[dtype] = out["stage1"]["prob_volume"]
        losses[dtype] = total
        if dtype == "bfloat16":
            assert out["stage1"]["prob_volume"].dtype == torch.bfloat16
            total.backward()
            for n, p in st.model.named_parameters():
                assert p.dtype == torch.float32, n
                assert torch.isfinite(p.grad).all(), n
    f32 = outs["float32"].detach().numpy()
    ours = outs["bfloat16"].float().detach().numpy()
    theirs = np.asarray(jout["stage1"]["prob_volume"].astype(jnp.float32))
    assert np.isfinite(ours).all()
    err_ours = np.abs(ours - f32).max()
    err_jax = np.abs(theirs - f32).max()
    assert err_ours <= BF16_VS_JAX * err_jax + 2.0 ** -8, (err_ours, err_jax)
    assert np.abs(ours - theirs).max() <= BF16_PROB_ATOL
    np.testing.assert_allclose(float(losses["bfloat16"]), float(jl),
                               rtol=BF16_LOSS_RTOL)
