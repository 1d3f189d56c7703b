"""The port's encoder factory (envidr_tpu_torch/ops/encoders.py) against the
JAX package's ``get_encoder``: every name, the output width and the values
on the same inputs, the grid encoders with the JAX tables handed over."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from envidr_tpu.ops.encoders import get_encoder as jax_get_encoder
from envidr_tpu_torch.ops.encoders import get_encoder
from test_torch_helpers import rel_err

# of the max: the same f32 arithmetic in another order (the CP encoder in the
# facade's bf16 too: the port rounds where JAX's op-by-op two-hot matmul
# rounds); readings 0 to 1.7e-7
FWD_RTOL = 1e-6
SMALL = dict(num_levels=4, level_dim=2, base_resolution=8, log2_hashmap_size=10,
             desired_resolution=64, rank=8)
NAMES = ["None", "frequency", "sphere_harmonics", "integrated_dir", "hashgrid",
         "hashgrid_diff", "tiledgrid", "rolled_tiled", "cp"]


def _inputs(name):
    rng = np.random.default_rng(3)
    if name in ("sphere_harmonics", "integrated_dir"):
        d = rng.normal(size=(64, 3))
        return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return rng.uniform(-1.0, 1.0, (64, 3)).astype(np.float32)


def _handed_over(module, params):
    """The port's grid encoder holding the JAX tables ``params``."""
    with torch.no_grad():
        if "embeddings" in params:
            module.embeddings.copy_(torch.from_numpy(np.array(params["embeddings"])))
        else:
            for lvl, axes in enumerate(params["axes"]):
                for a, table in enumerate(axes):
                    module.axes[lvl][a].copy_(torch.from_numpy(np.array(table)))
                module.proj[lvl].copy_(torch.from_numpy(np.array(params["proj"][lvl])))
    return module


@pytest.mark.parametrize("name", NAMES)
def test_get_encoder_matches_jax(name):
    kw = dict(SMALL, multires=4, degree=3)
    jenc, jdim, jinit = jax_get_encoder(name, **kw)
    enc, dim = get_encoder(name, generator=torch.Generator().manual_seed(0), **kw)
    assert dim == jdim
    x = _inputs(name)
    if jinit is None:
        assert not isinstance(enc, torch.nn.Module)
        extra = {"roughness": 0.2} if name == "integrated_dir" else {}
        ref = np.asarray(jenc(jnp.asarray(x), **extra))
        ours = enc(torch.from_numpy(x), **extra)
    else:
        params = jinit(jax.random.PRNGKey(1))
        ref = np.asarray(jenc(params, jnp.asarray(x)))
        module = _handed_over(enc, params)
        assert sum(p.numel() for p in module.parameters()) == sum(
            np.size(a) for a in jax.tree.leaves(params))
        ours = module(torch.from_numpy(x))
    assert tuple(ours.shape) == ref.shape == (64, dim)
    assert rel_err(ref, ours.detach().numpy()) <= FWD_RTOL


def test_identities_and_unknown_name():
    x = torch.zeros(2, 3)
    assert get_encoder("None")[0](x) is x
    enc, dim = get_encoder("frequency", multires=0)
    assert enc(x) is x and dim == 3
    with pytest.raises(NotImplementedError) as ours:
        get_encoder("fourier")
    with pytest.raises(NotImplementedError) as ref:
        jax_get_encoder("fourier")
    assert str(ours.value) == str(ref.value)


def test_grid_encoder_bound_and_gradient():
    """``bound`` rescales world positions as in JAX (``kw.get("bound")``),
    and the tables take gradients."""
    enc, _ = get_encoder("cp", generator=torch.Generator().manual_seed(2), bound=2.0, **SMALL)
    x = torch.from_numpy(_inputs("cp"))
    np.testing.assert_allclose(enc(x).detach().numpy(),
                               enc(x / 2.0, bound=1.0).detach().numpy(), rtol=0, atol=1e-6)
    enc(x).square().sum().backward()
    assert all(p.grad is not None for p in enc.parameters())
