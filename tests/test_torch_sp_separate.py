"""PyTorch port vs the JAX package: time-sharded separation
(parallel/sp_convtasnet). ``sp_separate`` and ``sp_separate_mossformer`` over
n shards of one device against the JAX functions on their virtual CPU mesh
and against the port's own dense masked forward, and the facade
``Separator.separate_long`` for both backends (CPU, float32).

Tolerance: 2e-4 of the output's max magnitude. Both sides are float32; the
shard sums (gLN statistics, the GAU partial sums) are taken in another order
than the dense forward takes them, through 6 TCN blocks or 2 GAU layers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audio_classification_tpu.parallel.sp_convtasnet as jax_sp
from audio_classification_tpu.models import facades as jax_facades
from audio_classification_tpu.models.convtasnet import ConvTasNet as JaxConvTasNet
from audio_classification_tpu.models.convtasnet import ConvTasNetConfig as JaxConvTasNetConfig
from audio_classification_tpu.models.mossformer import MossFormer as JaxMossFormer
from audio_classification_tpu.models.mossformer import MossFormerConfig as JaxMossFormerConfig
from audio_classification_tpu.parallel.mesh import make_mesh as jax_make_mesh
from audio_classification_tpu.parallel.sp_convtasnet import sp_separate as jax_sp_separate
from audio_classification_tpu.parallel.sp_convtasnet import (
    sp_separate_mossformer as jax_sp_separate_mossformer,
)
from audio_classification_tpu_torch.convert.from_jax import variables_to_state_dict
from audio_classification_tpu_torch.models import facades
from audio_classification_tpu_torch.models.convtasnet import ConvTasNet, ConvTasNetConfig
from audio_classification_tpu_torch.models.mossformer import MossFormer, MossFormerConfig
from audio_classification_tpu_torch.parallel.mesh import make_mesh
from audio_classification_tpu_torch.parallel.sp_convtasnet import (
    sp_separate,
    sp_separate_mossformer,
)
from torch_port_helpers import shared_engines

torch.set_num_threads(2)
TOL = 2e-4
TCN = dict(n_src=2, enc_dim=16, enc_kernel=16, bottleneck=8, hidden=16, conv_kernel=3,
           n_blocks=3, n_repeats=2, sample_rate=8000)
MOSS = dict(n_src=2, enc_dim=16, enc_kernel=16, dim=16, qk_dim=8, layers=2, conv_kernel=5,
            sample_rate=8000)


def cpu_mesh(n):
    return make_mesh(n, devices=["cpu"] * n)


def _perturbed(variables, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32),
        jax.device_get(variables))


def _pair(jax_cls, jax_cfg, cls, cfg, seed):
    """The JAX model's perturbed variables and the port's module on them."""
    variables = _perturbed(jax_cls(jax_cfg).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 1000)), jnp.ones((1, 1000))), seed)
    model = cls(cfg).eval()
    model.load_state_dict(variables_to_state_dict(variables))
    return variables, model


@pytest.fixture(scope="module")
def tcn():
    return _pair(JaxConvTasNet, JaxConvTasNetConfig(**TCN), ConvTasNet, ConvTasNetConfig(**TCN), 0)


@pytest.fixture(scope="module")
def moss():
    return _pair(JaxMossFormer, JaxMossFormerConfig(**MOSS), MossFormer,
                 MossFormerConfig(**MOSS), 1)


def _mix(t, lengths, seed):
    mix = (np.random.default_rng(seed).standard_normal((len(lengths), t)) * 0.3).astype(np.float32)
    for row, n in enumerate(lengths):
        mix[row, n:] = 0.0
    return mix


def _rel(got, ref):
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9)


def _jitted(jax_fn, jax_cfg, n):
    """The JAX function under jit: run op by op, its shard_map takes most of
    a minute at these sizes."""
    mesh = jax_make_mesh(n, model_axis=1)
    return jax.jit(lambda variables, mix, lengths: jax_fn(variables, jax_cfg, mix, lengths, mesh))


def _check(port_fn, jax_fn, jax_cfg, pair, n, t, lengths):
    """The port over n shards against the JAX function over n virtual
    devices and against the port's dense masked forward."""
    variables, model = pair
    lens = [t] * 2 if lengths is None else lengths
    mix = _mix(t, lens, 10 * n + t)
    with torch.no_grad():
        got = port_fn(model, torch.from_numpy(mix),
                      None if lengths is None else torch.tensor(lengths), cpu_mesh(n)).numpy()
        mask = torch.arange(t)[None, :] < torch.tensor(lens)[:, None]
        dense = model(torch.from_numpy(mix), mask.float()).numpy()
    ref = np.asarray(_jitted(jax_fn, jax_cfg, n)(
        variables, jnp.asarray(mix), None if lengths is None else jnp.asarray(lengths, jnp.int32)))
    assert got.shape == ref.shape == dense.shape == (2, 2, t)
    assert _rel(got, ref) < TOL
    assert _rel(got, dense) < TOL
    for row, ln in enumerate(lens):  # the padded tail stays silent
        assert np.all(got[row, :, ln:] == 0.0)
    assert np.abs(got).max() > 0


@pytest.mark.parametrize("n,t,lengths", [
    (8, 1000, [1000, 700]),   # a padded row; the frames tile neither stride nor mesh
    (4, 777, None),           # default lengths, t off the stride
    (2, 1000, [1000, 333]),
])
def test_sp_separate_matches_jax_and_dense(tcn, n, t, lengths):
    _check(sp_separate, jax_sp_separate, JaxConvTasNetConfig(**TCN), tcn, n, t, lengths)


@pytest.mark.parametrize("n,t,lengths", [
    (8, 1003, [1003, 700]),   # the round-up frames past the dense tiling are zeroed
    (4, 1003, None),
    (2, 640, [640, 500]),
])
def test_sp_separate_mossformer_matches_jax_and_dense(moss, n, t, lengths):
    _check(sp_separate_mossformer, jax_sp_separate_mossformer, JaxMossFormerConfig(**MOSS), moss,
           n, t, lengths)


def test_sp_separate_refuses_short_shards_and_int8(tcn, moss):
    """The reference's two refusals, with its messages."""
    mesh = cpu_mesh(8)
    with pytest.raises(ValueError, match=r"frames/shard < the TCN's widest halo \(4\)"):
        sp_separate(tcn[1], torch.zeros((1, 100)), None, mesh)
    with pytest.raises(ValueError, match=r"frames/shard < the conv halo \(2\)"):
        sp_separate_mossformer(moss[1], torch.zeros((1, 40)), None, mesh)
    q8 = ConvTasNet(dataclasses.replace(ConvTasNetConfig(**TCN), quant="int8"))
    with pytest.raises(ValueError, match="int8 pointwise convs"):
        sp_separate(q8, torch.zeros((1, 1000)), None, mesh)


@pytest.fixture(scope="module")
def engines():
    return shared_engines("none")


@pytest.fixture
def jax_sp_under_jit(monkeypatch):
    """The JAX facade looks its two functions up in their module at each
    call; it gets them under jit, for the reason ``_jitted`` gives."""
    for name in ("sp_separate", "sp_separate_mossformer"):
        fn = getattr(jax_sp, name)
        monkeypatch.setattr(
            jax_sp, name,
            lambda params, cfg, mix, lengths, mesh, axis="data", _fn=fn: jax.jit(
                lambda p, m: _fn(p, cfg, m, lengths, mesh, axis=axis))(params, mix))


@pytest.mark.parametrize("backend,n_src,sr,n", [
    ("convtasnet", 2, 16000, 8), ("convtasnet", 3, 16000, 4), ("mossformer", 2, 8000, 8)])
def test_separator_separate_long_matches_jax(engines, jax_sp_under_jit, backend, n_src, sr, n):
    """Separator.separate_long on the tiny preset's shared weights against the
    JAX facade on its mesh, and against the port's dense forward in float
    (``separate`` quantises the audio to int16 on the way, the long path does
    not)."""
    jax_eng, eng = engines
    wav = (np.random.default_rng(2).standard_normal(9000) * 0.3).astype(np.float32)
    got = facades.Separator(backend=backend, n_src=n_src, engine=eng).separate_long(
        wav, sr, cpu_mesh(n))
    ref = jax_facades.Separator(backend=backend, n_src=n_src, engine=jax_eng).separate_long(
        wav, sr, jax_make_mesh(n, model_axis=1))
    stage = "mossformer" if backend == "mossformer" else f"sep{n_src}"
    with torch.no_grad():
        dense = eng.pack.models[stage](torch.from_numpy(wav)[None], torch.ones((1, 9000)))[0]
    assert len(got) == len(ref) == n_src
    for g, r, d in zip(got, ref, dense.numpy()):
        assert g.shape == (9000,) and g.dtype == np.float32
        assert _rel(g, np.asarray(r)) < TOL
        assert _rel(g, d) < TOL


def test_separate_long_resamples_and_checks_the_source_count(engines):
    """Audio at another rate is resampled to the model's first; asking a
    2-stream backend for 3 sources fails as ``separate`` does."""
    eng = engines[1]
    wav = (np.random.default_rng(3).standard_normal(6000) * 0.3).astype(np.float32)
    sep = facades.Separator(backend="convtasnet", n_src=2, engine=eng)
    out = sep.separate_long(wav, 8000, cpu_mesh(4))
    assert out[0].shape == sep._ensure_sr(wav, 8000).shape == (12000,)
    moss3 = facades.Separator(backend="mossformer", n_src=2, engine=eng)
    moss3.n_src = 3
    with pytest.raises(RuntimeError, match="2 < 3 sources"):
        moss3.separate_long(wav, 8000, cpu_mesh(4))
