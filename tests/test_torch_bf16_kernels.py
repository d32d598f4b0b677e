"""The bfloat16 halves of K2 / K2-s8, K3 / K5 and K4 on the CPU: their
plain twins (``tcn_masker_reference_lowp``, ``attention_reference_lowp`` /
``attention_stats_reference_lowp``, ``gau_attention_reference`` on bf16
inputs) against the JAX kernels run in interpret mode at bf16, the
reference's bf16 length sum, and the dtypes the engine's bf16 mode hands
the attention kernels in both packages, path by path.

Tolerances are measured (the comment at each) and bounded by bf16's own
spacing: a twin and a kernel that sum in another order in float32 round an
element to the other neighbour now and then, and the masker's residual
stream carries such a flip into later blocks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_classification_tpu.engine import BucketSpec as JaxBucketSpec
from audio_classification_tpu.engine import ModelPack as JaxModelPack
from audio_classification_tpu.engine import StageEngine as JaxStageEngine
from audio_classification_tpu.engine import tiny_preset as jax_tiny_preset
from audio_classification_tpu.models.convtasnet import ConvTasNet as JaxTasNet
from audio_classification_tpu.models.convtasnet import ConvTasNetConfig as JaxTasNetConfig
from audio_classification_tpu.ops.pallas import attention_kernel as jax_attn
from audio_classification_tpu.ops.pallas.tcn_kernel import fused_tcn_masker as jax_fused_tcn
from audio_classification_tpu.ops.pallas.tcn_kernel import stack_tcn_params as jax_stack
from audio_classification_tpu_torch.convert.from_jax import params_to_state_dicts
from audio_classification_tpu_torch.engine import BucketSpec, ModelPack, StageEngine, tiny_preset
from audio_classification_tpu_torch.models import common, mossformer
from audio_classification_tpu_torch.models.convtasnet import ConvTasNet, ConvTasNetConfig
from audio_classification_tpu_torch.models.convtasnet import _frame_lengths
from audio_classification_tpu_torch.ops.kernels import attention, gau, tcn

torch.set_num_threads(2)
BF = torch.bfloat16

# valid rows, max |twin - JAX kernel| over max |JAX kernel| (measured 8.9e-3
# on the float and the int8 stack, about one bf16 spacing at the maximum;
# mean 1.1e-3 / 1.3e-3): after one block 0.2% of the elements differ, by
# one rounding of the other's; after eight the residual stream has carried
# such flips into most rows (tests/test_bf16.py allows 5e-2 between f32 and
# bf16). Padded rows exactly 0.
MASKER_TOL = 2e-2
MASKER_MEAN_TOL = 3e-3
# K4: the p rounding to bf16 is the same in both, the sums' order is not
# (measured 3.0e-7; the float32 p v on the unrounded p is 1.5e-3 away)
GAU_TOL = 1e-5
# K3 / K5 at JAX's key blocks: float32 summation order moves a p across a
# bf16 rounding boundary now and then, and one flip moves an output by up
# to 2^-9 p |v| / l, so the max error is that of a few flips (measured
# <= 4.2e-4 of max|o|) while the mean stays at float32 level (measured
# <= 2.8e-6 of mean|o|). Rounding p against another block partition (the
# kernels' 64 keys) or not at all is another function: mean 5.5e-4 and
# 1.4e-3. m absolute, l relative (measured 1.2e-6 both).
FLASH_TOL = 1e-3
FLASH_MEAN_TOL = 2e-5
FLASH_STATS_TOL = 1e-5

WIDE = dict(n_src=3, enc_dim=64, enc_kernel=16, bottleneck=128, hidden=128, n_blocks=4,
            n_repeats=2)


@pytest.fixture(scope="module")
def wide_case():
    """A Conv-TasNet at lane-multiple widths (C = H = 128, 2 x 4 blocks),
    weights cast to bf16 as the engines' bf16 copies cast them: the JAX
    block trees and the port's module."""
    rng = np.random.default_rng(21)
    variables = JaxTasNet(JaxTasNetConfig(**WIDE, fused_tcn="off")).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 800)), jnp.ones((1, 800)))
    variables = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32),
        jax.device_get(variables))
    sd = params_to_state_dicts({"sep3": variables})["sep3"]
    model = ConvTasNet(ConvTasNetConfig(**WIDE)).eval()
    model.load_state_dict(sd)
    model = model.to(BF)
    blocks = [jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16),
                           variables["params"][f"tcn_{r}_{x}"])
              for r in range(2) for x in range(4)]
    x = rng.normal(size=(3, 150, 128)).astype(np.float32)
    f_len = np.array([150, 97, 1], np.int32)
    return model, blocks, x, f_len


@pytest.mark.parametrize("quant", [False, True])
def test_bf16_stack_matches_jax(wide_case, quant):
    """stack_tcn_params at bf16: bf16 weight matrices (or the int8 stream)
    and float32 vector bundles from the bf16-rounded parameters, equal to
    the JAX stack's."""
    model, blocks, _, _ = wide_case
    st = tcn.stack_tcn_params(model.tcn_blocks(), BF, weight_quant=quant)
    st_jax = jax_stack(blocks, jnp.bfloat16, weight_quant=quant)
    for k, v in st_jax.items():
        assert str(st[k].dtype).split(".")[-1] == str(v.dtype), k
        np.testing.assert_array_equal(st[k].detach().float().numpy(),
                                      np.asarray(v).astype(np.float32), err_msg=k)


@pytest.mark.parametrize("quant", [False, True])
def test_bf16_masker_twin_matches_pallas_kernel(wide_case, quant):
    """K2 / K2-s8's bf16 twin (what the wrapper runs on the CPU) against
    the JAX kernel at bf16, interpret mode, tile 64, on a ragged batch:
    valid rows within MASKER_TOL, padded rows exactly 0."""
    model, blocks, x, f_len = wide_case
    st = tcn.stack_tcn_params(model.tcn_blocks(), BF, weight_quant=quant)
    xb = torch.from_numpy(x).to(BF)
    out = tcn.fused_tcn_masker(xb, torch.from_numpy(f_len), st, n_per_repeat=4)
    assert out.dtype == BF
    ref = np.asarray(jax_fused_tcn(jnp.asarray(x, jnp.bfloat16), jnp.asarray(f_len),
                                   jax_stack(blocks, jnp.bfloat16, weight_quant=quant),
                                   n_per_repeat=4, tile=64, interpret=True)).astype(np.float32)
    got = out.detach().float().numpy()
    valid = (np.arange(x.shape[1])[None, :] < f_len[:, None])[..., None]
    err = np.abs((got - ref) * valid)
    scale = np.abs(ref * valid).max()
    assert err.max() / scale < MASKER_TOL
    assert err.sum() / (valid.sum() * x.shape[-1]) / scale < MASKER_MEAN_TOL
    assert not (got * ~valid).any()


def test_bf16_masker_twin_rounds_residual_and_skips_each_block(wide_case):
    """The residual stream and the skip sum are bf16 in the twin, as the
    JAX kernel's dt scratch: the float64 twin, which rounds at the same
    points, stays within bf16's spacing of the float32 one, while the same
    blocks carried in float32 (the float twin on float32 copies) do not
    agree with either to that degree."""
    model, _, x, f_len = wide_case
    st = tcn.stack_tcn_params(model.tcn_blocks(), BF)
    xb, fl = torch.from_numpy(x).to(BF), torch.from_numpy(f_len)
    lo = tcn.tcn_masker_reference_lowp(xb, fl, st, n_per_repeat=4)
    hi = tcn.tcn_masker_reference_lowp(xb, fl, st, n_per_repeat=4, acc=torch.float64)
    assert lo.dtype == hi.dtype == BF
    f32 = tcn.tcn_masker_reference(xb.float(), fl, {k: v.float() for k, v in st.items()},
                                   n_per_repeat=4)
    valid = (torch.arange(x.shape[1])[None, :] < fl[:, None])[..., None]
    scale = (f32.abs() * valid).max()
    d_acc = ((lo.float() - hi.float()).abs() * valid).max() / scale
    d_f32 = ((lo.float() - f32).abs() * valid).max() / scale
    assert d_acc < MASKER_TOL and d_f32 > 2 ** -9


def _gau_inputs(seed=5, b=3, t=300, dqk=32, de=96):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((b, t, dqk)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((b, t, de)).astype(np.float32)
    mask = np.arange(t)[None, :] < np.array([t, 111, 0])[:b, None]  # the last item masked whole
    return q, k, v, mask


def test_bf16_gau_twin_matches_pallas_kernel():
    """K4's bf16 twin (p rounded to bf16 before p v, float32 out) against
    the JAX kernel at bf16 in interpret mode; the masked item is exactly 0."""
    q, k, v, mask = _gau_inputs()
    scale = 4.0 / q.shape[1]
    tq, tk, tv = (torch.from_numpy(a).to(BF) for a in (q, k, v))
    out = gau.gau_attention(tq, tk, tv, torch.from_numpy(mask), scale)
    assert out.dtype == torch.float32
    ref = np.asarray(jax_attn.gau_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                                            jnp.asarray(mask), scale, interpret=True))
    got = out.numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < GAU_TOL
    assert not got[2].any()
    # p v in float32 on the unrounded p (the float32 twin on the same bf16
    # values) is another function: the rounding point is there
    f32 = gau.gau_attention_reference(tq.float(), tk.float(), tv.float(),
                                      torch.from_numpy(mask), scale).numpy()
    assert np.abs(f32 - ref).max() / np.abs(ref).max() > 10 * GAU_TOL


def test_bf16_gau_wrapper_refuses_mixed_dtypes():
    q, k, v, mask = _gau_inputs()
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    with pytest.raises(ValueError, match="bfloat16"):
        gau.gau_attention(tq.to(BF), tk.to(BF), tv, torch.from_numpy(mask), 1.0)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        gau.gau_attention(tq.half(), tk.half(), tv.half(), torch.from_numpy(mask), 1.0)


def test_bf16_masker_wrapper_refuses_mixed_dtypes(wide_case):
    model, _, x, f_len = wide_case
    st = tcn.stack_tcn_params(model.tcn_blocks(), BF)
    with pytest.raises(ValueError, match="w_in must be torch.float32"):
        tcn.fused_tcn_masker(torch.from_numpy(x), torch.from_numpy(f_len), st, n_per_repeat=4)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tcn.fused_tcn_masker(torch.from_numpy(x).half(), torch.from_numpy(f_len), st,
                             n_per_repeat=4)


@pytest.mark.parametrize("n,total", [(320000, 319488), (4001, 4000), (257, 256), (4000, 4000)])
@pytest.mark.parametrize("enc_kernel,stride", [(32, 16), (16, 8)])
def test_bf16_length_sum_as_the_reference(n, total, enc_kernel, stride):
    """The reference sums the bf16 sample mask in bf16
    (models/convtasnet.py:117, models/mossformer.py:105): 320000 valid
    samples count as 319488, 4001 as 4000. The port keeps that fault, so its
    frame lengths and frame mask are the reference's; in float32 both are
    exact."""
    for dt, jdt, want in ((BF, jnp.bfloat16, total), (torch.float32, jnp.float32, n)):
        sm = torch.ones((1, n), dtype=dt)
        jsm = jnp.ones((1, n), jdt)
        lengths = jnp.sum(jsm, axis=-1)
        assert float(lengths[0]) == want and float(sm.sum(dim=-1)[0]) == want
        # models/convtasnet.py:117-119, as written there
        f_len = jnp.maximum((lengths - enc_kernel) // stride + 1, 1)
        n_frames = (n - enc_kernel) // stride + 2
        ref_mask = np.asarray(jnp.arange(n_frames)[None, :] < f_len[:, None])
        got = _frame_lengths(sm, enc_kernel, stride)
        assert float(got[0]) == float(f_len[0])
        np.testing.assert_array_equal(
            (torch.arange(n_frames)[None, :] < got[:, None]).numpy(), ref_mask)


def _record(calls, fn, name):
    def wrapped(q, *args, **kwargs):
        calls.append((name, str(q.dtype).split(".")[-1]))
        return fn(q, *args, **kwargs)
    return wrapped


@pytest.fixture(scope="module")
def bf16_dtypes_seen():
    """Both packages' bf16 engines on shared tiny weights run OSD, ASR and
    MossFormer separation with every attention core forced onto its kernel
    (the JAX package's ACT_FLASH_ATTN=1, the port's FLASH_MIN_T = 1); each
    kernel entry records the dtype of q."""
    jax_pack = JaxModelPack(jax_tiny_preset(), seed=0)  # its init traces the models too
    pack = ModelPack(tiny_preset(), seed=1, device="cpu")
    pack.load_state_dicts(params_to_state_dicts({k: jax_pack.params[k] for k in ModelPack.STAGES}))
    mp = pytest.MonkeyPatch()
    seen = {"jax": [], "torch": []}
    try:
        mp.setenv("ACT_FLASH_ATTN", "1")
        mp.setattr(jax_attn, "flash_attention",
                   _record(seen["jax"], jax_attn.flash_attention, "attn"))
        mp.setattr(jax_attn, "gau_attention", _record(seen["jax"], jax_attn.gau_attention, "gau"))
        mp.setattr(common, "FLASH_MIN_T", 1)
        mp.setattr(common, "flash_attention", _record(seen["torch"], common.flash_attention,
                                                      "attn"))
        mp.setattr(mossformer, "FLASH_MIN_T", 1)
        mp.setattr(mossformer, "gau_attention", _record(seen["torch"], mossformer.gau_attention,
                                                        "gau"))
        x = (np.random.default_rng(0).standard_normal(8000) * 0.1).astype(np.float32)
        for eng in (JaxStageEngine(jax_pack, JaxBucketSpec((8000,), 1), compute_dtype="bfloat16"),
                    StageEngine(pack, BucketSpec((8000,), 1), compute_dtype="bfloat16")):
            eng.osd_segments(x, 16000, 0.5, 0.5, 0.1)
            eng.transcribe([x])
            eng.separate([x], backend="mossformer")
    finally:
        mp.undo()
    return seen


def test_bf16_attention_cores_receive_float32_in_both_packages(bf16_dtypes_seen,
                                                               bf16_dtypes_by_path):
    """At bf16 the dtype that reaches K3 / K5 is float32 on every engine
    path, in both packages: OSDNet, SenseVoice and the other families'
    encoders add their float32 positional table before the first block,
    which promotes the stream, the mesh's rings included (so K3 / K5's bf16
    entry points are on no engine path). Per path (``PATHS``): the same
    entries in the same order in both packages; the rings' as sets, since
    the port calls K5 once a shard and step while the JAX shard body is
    traced once a layer for its first block and once for the loop over the
    others. The mesh's encoder rings reach K5; Paraformer's decoder, over
    its few acoustic tokens and never sharded, K3."""
    for pkg in ("jax", "torch"):
        attn = [dt for name, dt in bf16_dtypes_seen[pkg] if name == "attn"]
        assert attn and set(attn) == {"float32"}, pkg
    for path in PATHS:
        seen = bf16_dtypes_by_path[path]
        assert seen["torch"] and seen["jax"], path
        if path.startswith("mesh"):
            assert set(seen["torch"]) == set(seen["jax"]), path
        else:
            assert seen["torch"] == seen["jax"], path
        want = {"mesh-sensevoice": {"stats"},
                "mesh-paraformer": {"stats", "attn"}}.get(path, {"attn"})
        assert {name for name, _ in seen["torch"]} == want, path
        assert {dt for _, dt in seen["torch"]} == {"float32"}, path


def test_bf16_gau_sees_both_dtypes_in_one_forward(bf16_dtypes_seen):
    """MossFormer at bf16 hands K4 bf16 q, k, v in its first layer and
    float32 after: the kernel's float32 output promotes ``u * out``, and the
    residual stream turns float32. The same in both packages."""
    gau_dts = {pkg: [dt for name, dt in calls if name == "gau"]
               for pkg, calls in bf16_dtypes_seen.items()}
    assert gau_dts["torch"] == gau_dts["jax"] == ["bfloat16", "float32"]


def _flash_inputs(d, seed=0, b=2, h=2, tq=300, tk=300, valid=(300, 111)):
    rng = np.random.default_rng(seed + d)
    q = rng.standard_normal((b, h, tq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, h, tk, d)).astype(np.float32) for _ in range(2))
    mask = np.arange(tk)[None, :] < np.array(valid)[:, None]
    return q, k, v, mask


def _jax_block_k(tk):
    """The JAX kernel's key block at its defaults (attention_kernel.py:247)."""
    return min(256, -(-tk // 128) * 128)


def _assert_flash_close(got, want, tol=FLASH_TOL, mean_tol=FLASH_MEAN_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want)
    assert err.max() <= tol * np.abs(want).max()
    assert err.mean() <= mean_tol * np.abs(want).mean()


@pytest.mark.parametrize("fn", ["flash_attention", "flash_attention_stats"])
@pytest.mark.parametrize("d", [40, 64, 80, 128, 200])
def test_bf16_flash_twins_match_pallas_kernels(fn, d):
    """K3 / K5's bf16 twins at the JAX kernel's key blocks against the
    Pallas kernels at bf16 in interpret mode, ragged masks, D on both sides
    of the instances (40 and 200 zero-padded on the card): o within
    FLASH_TOL / FLASH_MEAN_TOL, m and l within FLASH_STATS_TOL. The same
    twin at the kernels' 64-key blocks is another function there."""
    tq, tk, valid = (300, 300, (300, 111)) if fn == "flash_attention" else (200, 333, (333, 70))
    q, k, v, mask = _flash_inputs(d, tq=tq, tk=tk, valid=valid)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    tb = [torch.from_numpy(a).to(BF) for a in (q, k, v)]
    tm = torch.from_numpy(mask)
    bk = _jax_block_k(tk)
    if fn == "flash_attention":
        want = np.asarray(jax_attn.flash_attention(*jb, jnp.asarray(mask), interpret=True))
        got = attention.attention_reference_lowp(*tb, tm, block_k=bk)
        assert got.dtype == torch.float32
        _assert_flash_close(got.numpy(), want)
        other = attention.attention_reference_lowp(*tb, tm, block_k=64).numpy()
    else:
        wo, wm, wl = (np.asarray(x) for x in jax_attn.flash_attention_stats(
            *jb, jnp.asarray(mask), interpret=True))
        o, m, l = attention.attention_stats_reference_lowp(*tb, tm, block_k=bk)
        assert o.dtype == m.dtype == l.dtype == torch.float32
        _assert_flash_close(o.numpy(), wo)
        assert np.abs(m.numpy() - wm).max() <= FLASH_STATS_TOL
        assert (np.abs(l.numpy() - wl) / wl).max() <= FLASH_STATS_TOL
        want, other = wo, attention.attention_stats_reference_lowp(*tb, tm, block_k=64)[0].numpy()
    assert np.abs(other - want).mean() > 10 * FLASH_MEAN_TOL * np.abs(want).mean()


def test_bf16_flash_twin_float64_has_the_same_rounding_points():
    """The float64 twin (``acc=torch.float64``) rounds p at the same points:
    it stays within FLASH_TOL of the float32 twin, while the float32 twin
    on the same values without the rounding does not agree to that mean."""
    q, k, v, mask = _flash_inputs(64, seed=5)
    tb = [torch.from_numpy(a).to(BF) for a in (q, k, v)]
    tm = torch.from_numpy(mask)
    lo = attention.attention_reference_lowp(*tb, tm)
    hi = attention.attention_reference_lowp(*tb, tm, acc=torch.float64)
    assert hi.dtype == torch.float64
    _assert_flash_close(lo.numpy(), hi.numpy())
    f32 = attention.attention_reference(*(x.float() for x in tb), tm)
    assert (f32 - hi).abs().mean() > 10 * FLASH_MEAN_TOL * hi.abs().mean()


@pytest.mark.parametrize("fn", ["flash_attention", "flash_attention_stats"])
def test_flash_kernels_still_refuse_bf16(fn):
    """The wrappers take bf16 q, k, v (the name is kept from when they
    refused them): on the CPU they run the bf16 twin over the kernels' own
    64-key tiles and return float32, as the Pallas kernel at those blocks
    does; they still refuse q, k, v of mixed dtypes and float16."""
    q, k, v, mask = _flash_inputs(64, seed=9, tq=200, tk=200, valid=(200, 40))
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    tb = [torch.from_numpy(a).to(BF) for a in (q, k, v)]
    tm = torch.from_numpy(mask)
    got = getattr(attention, fn)(*tb, tm)
    want = getattr(jax_attn, fn)(*jb, jnp.asarray(mask), block_k=attention.BLOCK_K,
                                 interpret=True)
    if fn == "flash_attention":
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=FLASH_TOL * np.abs(w).max())
    _assert_flash_close(got[0].numpy(), np.asarray(want[0]))
    for bad in ((tb[0], tb[1], tb[2].float()), tuple(x.half() for x in tb)):
        with pytest.raises(ValueError, match="all float32 or all bfloat16"):
            getattr(attention, fn)(*bad, tm)


# ------------------------------------------------------------ attention dtype per path
PATHS = ("paraformer", "transducer", "whisper", "pyannet-flagship", "mesh-sensevoice",
         "mesh-paraformer")


def _record_both(mp, seen):
    """Record the dtype of q at each K3 (``attn``) and K5 (``stats``) entry
    of both packages, every attention core forced onto its kernel."""
    from audio_classification_tpu_torch.parallel import ring_attention

    mp.setenv("ACT_FLASH_ATTN", "1")
    for name, fn in (("attn", "flash_attention"), ("stats", "flash_attention_stats")):
        mp.setattr(jax_attn, fn, _record(seen["jax"], getattr(jax_attn, fn), name))
    mp.setattr(common, "FLASH_MIN_T", 1)
    mp.setattr(common, "flash_attention", _record(seen["torch"], common.flash_attention, "attn"))
    mp.setattr(ring_attention, "FLASH_MIN_T", 1)
    mp.setattr(ring_attention, "flash_attention_stats",
               _record(seen["torch"], ring_attention.flash_attention_stats, "stats"))


@pytest.fixture(scope="module")
def bf16_dtypes_by_path():
    """Each path's bf16 engines in both packages on shared tiny weights:
    the three other families' bucketed transcription, the flagship with
    PyanNet serving OSD (the port's PyanNet, then SenseVoice; the JAX
    engine's bf16 osd_fn raises before any attention, ROADMAP §3, so its
    record is SenseVoice's) and long form over a mesh of 2 for the JAX
    LONG_FORM_FAMILIES."""
    from audio_classification_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from audio_classification_tpu_torch.models.pyannet import PyanNet, PyanNetConfig
    from audio_classification_tpu_torch.parallel.mesh import make_mesh
    from test_torch_asr_families import LENGTHS, family_packs
    from test_torch_long_form import _bursts
    from test_torch_pyannet import TINY

    wav = _bursts(8000, seed=3)
    out = {}
    for path in PATHS:
        family = path.split("-")[-1] if path.startswith("mesh") else path
        family = "sensevoice" if path == "pyannet-flagship" else family
        jax_pack, pack = family_packs(family)
        jspec, spec = JaxBucketSpec(LENGTHS, 4), BucketSpec(LENGTHS, 4)
        jkw, kw = {}, {}
        if path.startswith("mesh"):
            jkw = dict(mesh=jax_make_mesh(2, model_axis=1))
            kw = dict(mesh=make_mesh(2, devices=["cpu"] * 2))
        seen = {"jax": [], "torch": []}
        mp = pytest.MonkeyPatch()
        try:
            _record_both(mp, seen)
            jeng = JaxStageEngine(jax_pack, jspec, compute_dtype="bfloat16", **jkw)
            eng = StageEngine(pack, spec, compute_dtype="bfloat16", **kw)
            if path == "pyannet-flagship":
                cfg = PyanNetConfig(**TINY)
                pack.set_osd_pyannet(cfg, PyanNet(cfg).state_dict())
                eng.osd_segments(wav, 16000, 0.5, 0.5, 0.1)
            if path.startswith("mesh"):
                jeng.transcribe_long(wav)
                eng.transcribe_long(wav)
            else:
                jeng.transcribe([wav])
                eng.transcribe([wav])
        finally:
            mp.undo()
        out[path] = seen
    return out
