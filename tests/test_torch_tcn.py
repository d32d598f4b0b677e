"""PyTorch port vs the JAX package: K2's twin (the Conv-TasNet masker) and
the whole ConvTasNet (CPU, float32).

K2's twin is held to the Pallas kernel in interpret mode and to the JAX
reference loop on the same stacked weights, at C = H = 128 with 2 x 4
blocks, a ragged f_len and F not a multiple of the kernel's tile. Tolerance:
1e-4 x max|skips| on valid frames — float32, summation order differs over
the 128- and 512-wide contractions and the gLN reductions over F x H.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_classification_tpu.engine.runtime import tiny_preset as jax_tiny_preset
from audio_classification_tpu.models.convtasnet import ConvTasNet as JaxTasNet
from audio_classification_tpu.ops.pallas.tcn_kernel import (
    fused_tcn_masker as jax_fused_tcn_masker,
    stack_tcn_params as jax_stack_tcn_params,
    tcn_masker_reference as jax_tcn_reference,
)
from audio_classification_tpu_torch.convert.from_jax import params_to_state_dicts
from audio_classification_tpu_torch.engine.runtime import tiny_preset
from audio_classification_tpu_torch.models.convtasnet import ConvTasNet
from audio_classification_tpu_torch.ops.kernels.tcn import (
    fused_tcn_masker,
    stack_tcn_params,
    tcn_masker_reference,
)

torch.set_num_threads(2)
NB_PER, NREP, C, H = 4, 2, 128, 128
TOL = 1e-4


def _blocks(rng):
    def mk():
        return {
            "in_conv": {"kernel": rng.normal(size=(1, C, H)).astype(np.float32) * 0.1,
                        "bias": rng.normal(size=(H,)).astype(np.float32) * 0.1},
            "prelu1": {"alpha": np.array([0.25], np.float32)},
            "norm1": {"gamma": rng.normal(size=(H,)).astype(np.float32) * 0.5 + 1.0,
                      "beta": rng.normal(size=(H,)).astype(np.float32) * 0.1},
            "dw_conv": {"kernel": rng.normal(size=(3, 1, H)).astype(np.float32) * 0.3,
                        "bias": rng.normal(size=(H,)).astype(np.float32) * 0.1},
            "prelu2": {"alpha": np.array([0.3], np.float32)},
            "norm2": {"gamma": rng.normal(size=(H,)).astype(np.float32) * 0.5 + 1.0,
                      "beta": rng.normal(size=(H,)).astype(np.float32) * 0.1},
            "res_conv": {"kernel": rng.normal(size=(1, H, C)).astype(np.float32) * 0.1,
                         "bias": rng.normal(size=(C,)).astype(np.float32) * 0.1},
            "skip_conv": {"kernel": rng.normal(size=(1, H, C)).astype(np.float32) * 0.1,
                          "bias": rng.normal(size=(C,)).astype(np.float32) * 0.1},
        }

    return [mk() for _ in range(NB_PER * NREP)]


@pytest.fixture(scope="module")
def masker_case():
    rng = np.random.default_rng(0)
    blocks = _blocks(rng)
    st = jax_stack_tcn_params([jax.tree.map(jnp.asarray, b) for b in blocks], jnp.float32)
    x = rng.normal(size=(2, 150, C)).astype(np.float32)  # 150: not a multiple of tile=64
    f_len = np.array([150, 97], np.int32)
    st_np = {k: np.array(v) for k, v in st.items()}
    out = tcn_masker_reference(torch.from_numpy(x), torch.from_numpy(f_len),
                               {k: torch.from_numpy(v) for k, v in st_np.items()},
                               n_per_repeat=NB_PER).numpy()
    return blocks, st, x, f_len, out


def _valid_err(out, ref, f_len):
    valid = (np.arange(out.shape[1])[None, :] < f_len[:, None])[..., None]
    return np.abs((out - ref) * valid).max() / np.abs(ref * valid).max()


def test_tcn_twin_matches_pallas_kernel(masker_case):
    _, st, x, f_len, out = masker_case
    ref = np.asarray(jax_fused_tcn_masker(jnp.asarray(x), jnp.asarray(f_len), st,
                                          n_per_repeat=NB_PER, tile=64, interpret=True))
    assert out.shape == ref.shape
    assert _valid_err(out, ref, f_len) < TOL


def test_tcn_twin_matches_jax_reference_loop(masker_case):
    _, st, x, f_len, out = masker_case
    ref = np.asarray(jax_tcn_reference(jnp.asarray(x), jnp.asarray(f_len), st,
                                       n_per_repeat=NB_PER))
    assert _valid_err(out, ref, f_len) < TOL


def test_tcn_wrapper_on_cpu_runs_twin_and_counts_no_launch(masker_case):
    _, st, x, f_len, out = masker_case
    before = fused_tcn_masker.launches
    got = fused_tcn_masker(torch.from_numpy(x), torch.from_numpy(f_len),
                           {k: torch.from_numpy(np.array(v)) for k, v in st.items()},
                           n_per_repeat=NB_PER).numpy()
    np.testing.assert_array_equal(got, out)
    assert fused_tcn_masker.launches == before


def test_tcn_wrapper_rejects_int8_stack(masker_case):
    """The int8 weight stream is taken only whole: int8 weights without their
    scale rows (vecs [NB, 10, H], cvecs [NB, 4, C]), one weight left float, or
    a scale row of another width are rejected, on the CPU too."""
    blocks, _, x, f_len, _ = masker_case
    st8 = jax_stack_tcn_params([jax.tree.map(jnp.asarray, b) for b in blocks], jnp.float32,
                               weight_quant=True)
    st8 = {k: torch.from_numpy(np.array(v)) for k, v in st8.items()}
    args = (torch.from_numpy(x), torch.from_numpy(f_len))
    assert fused_tcn_masker(*args, st8, n_per_repeat=NB_PER).shape == x.shape
    for name, bad in (("vecs", st8["vecs"][:, :8].contiguous()),
                      ("cvecs", st8["cvecs"][:, :2].contiguous()),
                      ("w_dw", st8["w_dw"].float()),
                      ("vecs", st8["vecs"][:, :, :-1].contiguous())):
        with pytest.raises(ValueError, match=name):
            fused_tcn_masker(*args, {**st8, name: bad}, n_per_repeat=NB_PER)


@pytest.fixture(scope="module")
def tasnet_case():
    cfg = jax_tiny_preset().sep3
    rng = np.random.default_rng(7)
    variables = JaxTasNet(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 800)),
                                    jnp.ones((1, 800)))
    variables = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32),
        jax.device_get(variables))
    t = 3000
    wav = (0.3 * rng.standard_normal((2, t))).astype(np.float32)
    sm = (np.arange(t)[None, :] < np.array([t, 2100])[:, None]).astype(np.float32)
    ref = np.asarray(JaxTasNet(cfg).apply(variables, jnp.asarray(wav), jnp.asarray(sm)))
    sd = params_to_state_dicts({"sep3": variables})["sep3"]
    return variables, wav, sm, ref, sd


@pytest.mark.parametrize("fused_tcn", ["auto", "off"])
def test_convtasnet_matches_jax(tasnet_case, fused_tcn):
    """Tiny Conv-TasNet-3 with converted weights: the K2 path ("auto", the
    twin on CPU) and the dense block loop ("off") against the JAX dense
    model, 1e-4 relative to max|out|."""
    import dataclasses

    _, wav, sm, ref, sd = tasnet_case
    model = ConvTasNet(dataclasses.replace(tiny_preset().sep3, fused_tcn=fused_tcn)).eval()
    model.load_state_dict(sd)
    with torch.no_grad():
        out = model(torch.from_numpy(wav), torch.from_numpy(sm)).numpy()
    assert out.shape == ref.shape == (2, 3, wav.shape[1])
    assert np.abs(out - ref).max() / np.abs(ref).max() < TOL


def test_stack_tcn_params_matches_jax(tasnet_case):
    variables, _, _, _, sd = tasnet_case
    model = ConvTasNet(tiny_preset().sep3).eval()
    model.load_state_dict(sd)
    ours = stack_tcn_params(model.tcn_blocks())
    c = tiny_preset().sep3
    blocks = [variables["params"][f"tcn_{r}_{x}"]
              for r in range(c.n_repeats) for x in range(c.n_blocks)]
    theirs = jax_stack_tcn_params([jax.tree.map(jnp.asarray, b) for b in blocks], jnp.float32)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].detach().numpy(), np.asarray(v), err_msg=k)
