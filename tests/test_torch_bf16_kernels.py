"""The bfloat16 halves of K2 / K2-s8 and K4 on the CPU: their plain twins
(``tcn_masker_reference_lowp``, ``gau_attention_reference`` on bf16
inputs) against the JAX kernels run in interpret mode at bf16, the
reference's bf16 length sum, the dtypes the engine's bf16 mode hands the
attention kernels in both packages, and K3 / K5's refusal of bf16.

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
        np.testing.assert_array_equal(st[k].float().numpy(),
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
    got = out.float().numpy()
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


def test_bf16_attention_cores_receive_float32_in_both_packages(bf16_dtypes_seen):
    """At bf16 K3's inputs are float32 in both packages: OSDNet and
    SenseVoice add their float32 positional table before the first block,
    which promotes the stream (ROADMAP §2 item 1: K3 / K5's bf16 entry
    points stay unported and are on no engine path)."""
    for pkg in ("jax", "torch"):
        attn = [dt for name, dt in bf16_dtypes_seen[pkg] if name == "attn"]
        assert attn and set(attn) == {"float32"}, pkg


def test_bf16_gau_sees_both_dtypes_in_one_forward(bf16_dtypes_seen):
    """MossFormer at bf16 hands K4 bf16 q, k, v in its first layer and
    float32 after: the kernel's float32 output promotes ``u * out``, and the
    residual stream turns float32. The same in both packages."""
    gau_dts = {pkg: [dt for name, dt in calls if name == "gau"]
               for pkg, calls in bf16_dtypes_seen.items()}
    assert gau_dts["torch"] == gau_dts["jax"] == ["bfloat16", "float32"]


@pytest.mark.parametrize("fn", ["flash_attention", "flash_attention_stats"])
def test_flash_kernels_still_refuse_bf16(fn):
    q = torch.zeros((1, 2, 8, 16), dtype=BF)
    with pytest.raises(NotImplementedError, match=r"ROADMAP §2 item 1"):
        getattr(attention, fn)(q, q, q, None)
