"""Gradients of the kernels' autograd Functions (K2-K5, ops/kernels) on the
CPU, where the forward is the twin and the backward differentiates the twin,
against ``jax.grad`` through the JAX kernels in interpret mode (whose
``custom_vjp`` backward differentiates their XLA replicas).

Tolerances: float32 within 1e-5 of max|grad| (summation order over <= 300
keys or 8 TCN blocks); bfloat16 inputs within twice the JAX bf16 gradient's
own distance from the JAX float32 gradient on the same values (bf16 rounds
p, the cotangents and, in K2, the residual stream at every block, in both
packages at the same points but not in the same order); ``gradcheck`` in
float64 on tiny shapes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_classification_tpu.ops.pallas import tcn_kernel as jax_tcn
from audio_classification_tpu.ops.pallas.attention_kernel import (
    flash_attention as jax_flash,
    flash_attention_stats as jax_flash_stats,
    gau_attention as jax_gau,
)
from audio_classification_tpu_torch.ops.kernels.attention import (
    flash_attention,
    flash_attention_stats,
)
from audio_classification_tpu_torch.ops.kernels.gau import gau_attention
from audio_classification_tpu_torch.ops.kernels.tcn import (
    STACK_KEYS,
    fused_tcn_masker,
    stack_tcn_params,
    tcn_masker_reference,
    tcn_masker_reference_lowp,
)
from audio_classification_tpu_torch.parallel.mesh import make_mesh
from audio_classification_tpu_torch.parallel.ring_attention import (
    reference_attention,
    ring_attention,
)

torch.set_num_threads(2)
BF = torch.bfloat16
TOL = 1e-5


def _rng_arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _torch_grads(fn, arrays, dtype=torch.float32):
    """Leaves from numpy in ``dtype``, fn(*leaves) -> scalar, backward ->
    grads as float32 numpy."""
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_() for a in arrays]
    fn(*leaves).backward()
    return [x.grad.float().numpy() for x in leaves]


def _jax_grads(fn, arrays, dtype=jnp.float32):
    """jax.grad of fn at ``arrays`` cast to ``dtype`` (None: as they are)."""
    args = [jnp.asarray(a) if dtype is None else jnp.asarray(a).astype(dtype) for a in arrays]
    return [np.asarray(g.astype(jnp.float32))
            for g in jax.grad(fn, argnums=tuple(range(len(args))))(*args)]


def _assert_bf16_close(port_bf16, jax_bf16, jax_f32, record_property, name):
    """Port bf16 grads within twice the JAX bf16 grads' distance from JAX's
    float32 grads (each relative to max|float32 grad|)."""
    for i, (p, j, f) in enumerate(zip(port_bf16, jax_bf16, jax_f32)):
        own, err = _rel(j, f), float(np.abs(p - j).max() / np.abs(f).max())
        record_property(f"{name}_{i}", {"port_vs_jax_bf16": err, "jax_bf16_vs_f32": own})
        assert err <= 2 * own + 1e-6, (i, err, own)


# ---------------------------------------------------------------- K3 / K5

def _mask(t, lens):
    return np.arange(t)[None, :] < np.asarray(lens)[:, None]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k3_function_grads_match_jax(dtype, record_property):
    """K3 (_FlashCore) at [2, 2, 300, 64], ragged keys (300, 263): dq, dk,
    dv of sum(out * g) over valid query rows."""
    b, h, t, d = 2, 2, 300, 64
    q, k, v, g = _rng_arrays(0, *[(b, h, t, d)] * 4)
    mask = _mask(t, [t, 263])
    w = g * mask[:, None, :, None]

    def jloss(q_, k_, v_):
        out = jax_flash(q_, k_, v_, jnp.asarray(mask), block_q=128, block_k=128, interpret=True)
        return jnp.sum(out * w)

    def tloss(q_, k_, v_):
        return (flash_attention(q_, k_, v_, torch.from_numpy(mask)) * torch.from_numpy(w)).sum()

    want = _jax_grads(jloss, (q, k, v))
    if dtype == "float32":
        for got, ref in zip(_torch_grads(tloss, (q, k, v)), want):
            assert _rel(got, ref) < TOL
        return
    got = _torch_grads(tloss, (q, k, v), BF)
    ref = _jax_grads(jloss, (q, k, v), jnp.bfloat16)
    f32 = _jax_grads(jloss, [np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
                             for a in (q, k, v)])
    _assert_bf16_close(got, ref, f32, record_property, "k3_bf16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k5_function_grads_match_jax(dtype, record_property):
    """K5 (_FlashStatsCore) at [2, 2, 256, 64] with item 1 masked whole
    (every key at the -1e9 bias: the row max is all ties, split evenly, as
    jnp.max's VJP splits it): cotangents on all three of (o, m, l)."""
    b, h, t, d = 2, 2, 256, 64
    q, k, v, go, gm, gl = _rng_arrays(1, *[(b, h, t, d)] * 4, (b, h, t), (b, h, t))
    mask = _mask(t, [t, 0])

    def jloss(q_, k_, v_):
        o, m, l = jax_flash_stats(q_, k_, v_, jnp.asarray(mask), block_q=128, block_k=128,
                                  interpret=True)
        return jnp.sum(o * go) + jnp.sum(m * gm) + jnp.sum(l * gl)

    def tloss(q_, k_, v_):
        o, m, l = flash_attention_stats(q_, k_, v_, torch.from_numpy(mask))
        return ((o * torch.from_numpy(go)).sum() + (m * torch.from_numpy(gm)).sum()
                + (l * torch.from_numpy(gl)).sum())

    want = _jax_grads(jloss, (q, k, v))
    if dtype == "float32":
        for got, ref in zip(_torch_grads(tloss, (q, k, v)), want):
            assert _rel(got, ref) < TOL
        return
    got = _torch_grads(tloss, (q, k, v), BF)
    ref = _jax_grads(jloss, (q, k, v), jnp.bfloat16)
    f32 = _jax_grads(jloss, [np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
                             for a in (q, k, v)])
    _assert_bf16_close(got, ref, f32, record_property, "k5_bf16")


def test_ring_attention_grads_through_k5_equal_dense():
    """Ring attention over 2 shards of 512 frames, so each block goes
    through K5's Function: its gradients flow through m and l into the
    ring's merges and equal the one-shard dense attention's."""
    b, t, h, d = 1, 1024, 2, 16
    q, k, v, g = _rng_arrays(2, *[(b, t, h, d)] * 4)
    mask = torch.from_numpy(_mask(t, [900]))
    w = torch.from_numpy(g) * mask[:, :, None, None]
    mesh = make_mesh(2, devices=["cpu"] * 2)
    ring = _torch_grads(lambda *a: (ring_attention(*a, mesh, kv_mask=mask) * w).sum(), (q, k, v))
    dense = _torch_grads(lambda *a: (reference_attention(*a, mask) * w).sum(), (q, k, v))
    for got, ref in zip(ring, dense):
        assert _rel(got, ref) < TOL


# -------------------------------------------------------------------- K4

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k4_function_grads_match_jax(dtype, record_property):
    """K4 (_GauCore) at q, k [3, 300, 32], v [3, 300, 48], keys valid
    300 / 211 / 0 (item 2 masked whole: its output and gradients are 0),
    scale 1 / T."""
    b, t, dqk, de = 3, 300, 32, 48
    q, k, v, g = _rng_arrays(3, (b, t, dqk), (b, t, dqk), (b, t, de), (b, t, de))
    mask = _mask(t, [t, 211, 0])

    def jloss(q_, k_, v_):
        out = jax_gau(q_, k_, v_, jnp.asarray(mask), 1.0 / t, block_q=128, block_k=128,
                      interpret=True)
        return jnp.sum(out * g)

    def tloss(q_, k_, v_):
        return (gau_attention(q_, k_, v_, torch.from_numpy(mask), 1.0 / t)
                * torch.from_numpy(g)).sum()

    if dtype == "float32":
        got = _torch_grads(tloss, (q, k, v))
        for a, ref in zip(got, _jax_grads(jloss, (q, k, v))):
            assert _rel(a, ref) < TOL
        assert not np.any(got[0][2]) and not np.any(got[1][2]) and not np.any(got[2][2])
        return
    got = _torch_grads(tloss, (q, k, v), BF)
    ref = _jax_grads(jloss, (q, k, v), jnp.bfloat16)
    f32 = _jax_grads(jloss, [np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
                             for a in (q, k, v)])
    _assert_bf16_close(got, ref, f32, record_property, "k4_bf16")


# -------------------------------------------------------------------- K2

NB_PER, NREP, C, H = 4, 2, 128, 128


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


_conv = jax.lax.conv_general_dilated


def _conv_widened_transpose(lhs, rhs, *args, **kwargs):
    """jax.lax.conv_general_dilated whose bf16 VJP runs the transpose in
    float32 and rounds dlhs, drhs to the operands' dtype (JAX's own raises
    on a float32 cotangent meeting a bf16 kernel); other dtypes unchanged."""
    if lhs.dtype != jnp.bfloat16:
        return _conv(lhs, rhs, *args, **kwargs)

    @jax.custom_vjp
    def conv(a, b):
        return _conv(a, b, *args, **kwargs)

    def bwd(res, ct):
        a, b = res
        _, vjp = jax.vjp(lambda a_, b_: _conv(a_, b_, *args, **kwargs),
                         a.astype(jnp.float32), b.astype(jnp.float32))
        da, db = vjp(ct.astype(jnp.float32))
        return da.astype(a.dtype), db.astype(b.dtype)

    conv.defvjp(lambda a, b: (conv(a, b), (a, b)), bwd)
    return conv(lhs, rhs)


@pytest.fixture
def _force_fused(monkeypatch):
    """The JAX package's own switches for its fused masker on the CPU."""
    monkeypatch.setenv("ACT_FUSED_TCN", "1")
    monkeypatch.setenv("ACT_FUSED_TCN_TILE", "64")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k2_function_grads_match_jax(_force_fused, monkeypatch, dtype, record_property):
    """K2 (_MaskerCore) over 2 x 4 blocks at C = H = 128, F = 150 with
    f_len (150, 97): gradients for x and every stacked tensor of
    sum(out * g) over valid rows, against jax.grad through the Pallas
    masker (interpret, tile 64); at bfloat16 also against JAX's own bf16
    backward on the first 2 blocks."""
    rng = np.random.default_rng(4)
    blocks = [jax.tree.map(jnp.asarray, b) for b in _blocks(rng)]
    x, g = _rng_arrays(5, (2, 150, C), (2, 150, C))
    f_len = np.array([150, 97], np.int32)
    g = g * _mask(150, f_len)[..., None]
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    st = jax_tcn.stack_tcn_params(blocks, jdt)
    stack = [np.asarray(st[k].astype(jnp.float32)) for k in STACK_KEYS]

    def jloss(x_, *s):
        out = jax_tcn.fused_tcn_masker(x_, jnp.asarray(f_len), dict(zip(STACK_KEYS, s)),
                                       n_per_repeat=NB_PER, tile=64, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * g)

    def tloss(x_, *s):
        st_ = dict(zip(STACK_KEYS, s))
        st_["vecs"], st_["cvecs"] = st_["vecs"].float(), st_["cvecs"].float()
        return (fused_tcn_masker(x_, torch.from_numpy(f_len), st_, n_per_repeat=NB_PER).float()
                * torch.from_numpy(g)).sum()

    if dtype == "float32":
        got = _torch_grads(tloss, (x, *stack))
        for name, a, ref in zip(("x",) + STACK_KEYS, got, _jax_grads(jloss, (x, *stack))):
            assert _rel(a, ref) < TOL, name
        return

    # bf16 activations and weight matrices, float32 vector bundles, as the
    # bf16 stack holds them. The JAX masker's own bf16 backward raises
    # (TypeError: its depthwise conv's transpose meets a float32 cotangent
    # and a bf16 kernel), so the yardstick is the JAX float32 gradient on
    # the same bf16 values. The port's bf16 gradient is autodiff through
    # the bf16 twin: the residual stream, the skip sum and their cotangents
    # round to bf16 at each of the 8 blocks, which puts it 8-12 % of max
    # (7-9 % in norm) from float32 here; w_skip, one product from the
    # output, 1 %. Held to 15 % in norm (cosine > 0.99 with the float32
    # gradient) and 25 % of max.
    bf_args = ([jnp.asarray(a, jnp.bfloat16) for a in (x, *stack[:4])]
               + [jnp.asarray(a) for a in stack[4:]])
    with pytest.raises(TypeError, match="same dtypes"):
        jax.grad(jloss)(*bf_args)
    f32 = _jax_grads(jloss, [np.asarray(a.astype(jnp.float32)) for a in bf_args])
    leaves = [torch.from_numpy(np.asarray(a.astype(jnp.float32)))
              .to(BF if a.dtype == jnp.bfloat16 else torch.float32).requires_grad_()
              for a in bf_args]
    tloss(*leaves).backward()
    for name, t, ref in zip(("x",) + STACK_KEYS, leaves, f32):
        got = t.grad.double().numpy()
        norm_err = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
        record_property(f"k2_bf16_{name}", {"max": _rel(got, ref), "norm": norm_err})
        assert norm_err < 0.15 and _rel(got, ref) < 0.25, (name, norm_err, _rel(got, ref))

    # JAX's own bf16 backward, on the first 2 blocks: bf16 flips compound
    # down the residual stream, so by 8 blocks the two packages' bf16
    # gradients are as far apart as each is from float32, while at 2 they
    # agree within 1 % (in norm, per tensor). JAX's transpose of the
    # depthwise conv raises at bf16 (above), so the test widens that one
    # transpose to float32 and rounds its results to the operands' dtype, as
    # JAX's dot_general transpose does. Two wrong backwards on the same
    # values must miss the bound: a float32 one (its gradients rounded to
    # bf16), and the bf16 twin with the kernels' bias order x + (res + b)
    # in place of the JAX replica's (x + res) + b.
    monkeypatch.setattr(jax.lax, "conv_general_dilated", _conv_widened_transpose)
    two = [a[:2] if i else a for i, a in enumerate(bf_args)]
    ref = _jax_grads(jloss, two, dtype=None)
    vals = [np.asarray(a.astype(jnp.float32)) for a in two]
    bf = [a.dtype == jnp.bfloat16 for a in two]

    def port_grads(fn, wide=False):
        leaves = [torch.from_numpy(a).to(BF if b and not wide else torch.float32)
                  .requires_grad_() for a, b in zip(vals, bf)]
        fn(*leaves).backward()
        return [(t.grad.to(BF) if b else t.grad).double().numpy() for t, b in zip(leaves, bf)]

    def twin_loss(twin, bias_last=None):
        def loss(x_, *s):
            kw = {} if bias_last is None else {"bias_last": bias_last}
            out = twin(x_, torch.from_numpy(f_len), dict(zip(STACK_KEYS, s)),
                       n_per_repeat=NB_PER, **kw)
            return (out.float() * torch.from_numpy(g)).sum()
        return loss

    def within(grads, label):
        errs = [(_rel(a, r), float(np.linalg.norm(a - r) / np.linalg.norm(r)))
                for a, r in zip(grads, ref)]
        record_property(f"k2_bf16_vs_jax_bf16_{label}", errs)
        return all(m <= 3e-2 and n <= 2e-2 for m, n in errs)

    assert within(port_grads(tloss), "port")
    assert not within(port_grads(twin_loss(tcn_masker_reference), wide=True), "float32 backward")
    assert not within(port_grads(twin_loss(tcn_masker_reference_lowp, bias_last=False)),
                      "kernel bias order")


def test_stack_gradient_reaches_the_tcn_blocks():
    """A Conv-TasNet whose masker runs K2's Function (fused_tcn "auto")
    gets the dense loop's ("off") parameter gradients: the stack built with
    grad on stays attached to each TCNBlock through torch.stack."""
    import dataclasses

    from audio_classification_tpu_torch.engine.runtime import seeded_init_, tiny_preset
    from audio_classification_tpu_torch.models.convtasnet import ConvTasNet

    cfg = tiny_preset().sep3
    fused = seeded_init_(ConvTasNet(cfg), torch.Generator().manual_seed(0)).eval()
    dense = ConvTasNet(dataclasses.replace(cfg, fused_tcn="off")).eval()
    dense.load_state_dict(fused.state_dict())
    rng = np.random.default_rng(6)
    mix = torch.from_numpy((0.3 * rng.standard_normal((2, 1600))).astype(np.float32))
    mask = torch.from_numpy(_mask(1600, [1600, 1100]).astype(np.float32))
    for m in (fused, dense):
        (m(mix, mask) ** 2).sum().backward()
    grads = dict(dense.named_parameters())
    for name, p in fused.named_parameters():
        # the last block's residual conv feeds nothing: the dense loop leaves
        # its grad None, the stack gives it zeros
        ref = grads[name].grad
        ref = torch.zeros_like(p) if ref is None else ref
        assert p.grad is not None, name
        assert (p.grad - ref).abs().max() <= 1e-4 * ref.abs().max() + 1e-12, name


def test_int8_stack_backward_raises():
    """The int8 weight stream is inference-only: its backward raises the
    JAX package's NotImplementedError."""
    from audio_classification_tpu_torch.engine.runtime import seeded_init_, tiny_preset
    from audio_classification_tpu_torch.models.convtasnet import ConvTasNet

    model = seeded_init_(ConvTasNet(tiny_preset().sep3), torch.Generator().manual_seed(0))
    st = stack_tcn_params(model.tcn_blocks(), weight_quant=True)
    x = torch.randn(1, 40, tiny_preset().sep3.bottleneck, requires_grad=True)
    out = fused_tcn_masker(x, torch.tensor([40]), st, n_per_repeat=2)
    with pytest.raises(NotImplementedError, match="inference-only"):
        out.sum().backward()


# ------------------------------------------------- float64 gradcheck, routing

def _tiny_stack(nb=2, c=4, h=8, seed=7):
    g = torch.Generator().manual_seed(seed)
    d = torch.float64

    def r(*shape, s=0.3):
        return torch.randn(*shape, generator=g, dtype=d) * s

    base = torch.tensor([0, .25, 1, 0, 0, .25, 1, 0], dtype=d)[None, :, None]
    return {"w_in": r(nb, c, h), "w_dw": r(nb, 3, h), "w_res": r(nb, h, c), "w_skip": r(nb, h, c),
            "vecs": r(nb, 8, h, s=0.1) + base, "cvecs": r(nb, 2, c, s=0.1)}


@pytest.mark.parametrize("kernel", ["k2", "k2_one_block", "k3", "k4", "k5"])
def test_gradcheck_float64(kernel):
    """torch.autograd.gradcheck of each Function in float64 on tiny ragged
    shapes (K5's wholly masked item is left out: at the -1e9 bias a float64
    finite difference of 1e-6 is below the bias's rounding)."""
    g = torch.Generator().manual_seed(8)
    d = torch.float64
    mask = torch.tensor([[True] * 9, [True] * 5 + [False] * 4])

    def leaf(*shape):
        return torch.randn(*shape, generator=g, dtype=d).requires_grad_()

    if kernel.startswith("k2"):  # one block: its w_res feeds nothing, its gradient is 0
        nb = 1 if kernel == "k2_one_block" else 2
        st = {k: v.requires_grad_() for k, v in _tiny_stack(nb).items()}
        fl = torch.tensor([7, 4])
        fn = lambda x, *s: fused_tcn_masker(x, fl, dict(zip(STACK_KEYS, s)), n_per_repeat=2)  # noqa: E731
        args = (leaf(2, 7, 4), *(st[k] for k in STACK_KEYS))
    elif kernel == "k4":
        fn = lambda q, k, v: gau_attention(q, k, v, mask, 1.0 / 9)  # noqa: E731
        args = (leaf(2, 9, 4), leaf(2, 9, 4), leaf(2, 9, 6))
    else:
        op = flash_attention if kernel == "k3" else flash_attention_stats
        fn = lambda q, k, v: op(q, k, v, mask)  # noqa: E731
        args = (leaf(2, 2, 9, 4), leaf(2, 2, 9, 4), leaf(2, 2, 9, 4))
    assert torch.autograd.gradcheck(fn, args)


def test_wrappers_take_the_function_only_under_autograd():
    """Inference is unchanged: with grad off, or no input that requires
    grad, the wrappers run as before (no graph); with both, the call is one
    node of the Function."""
    q = torch.randn(1, 1, 8, 4, requires_grad=True)
    with torch.no_grad():
        assert flash_attention(q, q, q).grad_fn is None
    assert flash_attention(q.detach(), q.detach(), q.detach()).grad_fn is None
    assert type(flash_attention(q, q, q).grad_fn).__name__ == "_FlashCoreBackward"
    assert type(flash_attention_stats(q, q, q)[0].grad_fn).__name__ == "_FlashStatsCoreBackward"
    g3 = torch.randn(1, 8, 4, requires_grad=True)
    assert type(gau_attention(g3, g3, g3, None, 0.1).grad_fn).__name__ == "_GauCoreBackward"


@pytest.mark.parametrize("kernel", ["k3", "k4", "k5"])
def test_backward_in_blocks_equals_one_block(monkeypatch, kernel):
    """The backward recomputes the twin a block of query rows at a time
    (attention.backward_rows): with blocks of 256 rows over T = 600 (three
    blocks) the gradients equal one block's, to float32 summation order."""
    from audio_classification_tpu_torch.ops.kernels import attention

    t = 600
    mask = torch.from_numpy(_mask(t, [t, 411]))
    if kernel == "k4":
        shapes = [(2, t, 32), (2, t, 32), (2, t, 48)]
        fn = lambda q, k, v: (gau_attention(q, k, v, mask, 1.0 / t) ** 2).sum()  # noqa: E731
    else:
        shapes = [(2, 2, t, 16)] * 3
        op = flash_attention if kernel == "k3" else flash_attention_stats

        def fn(q, k, v):
            out = op(q, k, v, mask)
            return sum((o ** 2).sum() for o in (out if isinstance(out, tuple) else (out,)))
    arrays = _rng_arrays(10, *shapes)
    whole = _torch_grads(fn, arrays)
    monkeypatch.setattr(attention, "BACKWARD_BLOCK_ELEMS", 1)
    assert attention.backward_rows(t, 4 * t) == 256
    for got, ref in zip(_torch_grads(fn, arrays), whole):
        assert _rel(got, ref) < 1e-6
