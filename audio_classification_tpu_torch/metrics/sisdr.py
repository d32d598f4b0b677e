"""SI-SDR and permutation-invariant (PIT) evaluation (port of
audio_classification_tpu/metrics/sisdr.py).

Host (numpy) versions reproduce the reference formulas exactly
(reference: overlap3_core.py:48-117, evaluate_with_sources.py:286-441) and
are the parity oracles; the torch versions run the same math batched on the
tensors' device: the SDR matrix is a batched matmul and the permutation scan
is a static enumeration (N<=4, K<=3 -> at most 24 injective assignments), so
a whole bucket of overlap segments is scored in one pass.
"""
from __future__ import annotations

import itertools
from functools import lru_cache
from typing import List, Sequence, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# numpy parity implementations
# ---------------------------------------------------------------------------


def si_sdr(reference: np.ndarray, estimation: np.ndarray) -> float:
    """Scale-invariant SDR in dB (reference: overlap3_core.py:48-63).

    Mismatched lengths are truncated to the shorter; inputs are zero-meaned;
    returns NaN for zero-energy references.
    """
    if reference.shape != estimation.shape:
        n = min(reference.shape[-1], estimation.shape[-1])
        reference = reference[..., :n]
        estimation = estimation[..., :n]
    ref = reference.astype(np.float32) - float(np.mean(reference))
    est = estimation.astype(np.float32) - float(np.mean(estimation))
    ref_energy = float(np.sum(ref**2)) + 1e-12
    if ref_energy <= 0:
        return float("nan")
    scale = float(np.dot(est, ref)) / ref_energy
    proj = scale * ref
    e_noise = est - proj
    num = float(np.sum(proj**2)) + 1e-12
    den = float(np.sum(e_noise**2)) + 1e-12
    return 10.0 * float(np.log10(num / den))


@lru_cache(maxsize=16)
def _assignments(n_preds: int, k_refs: int) -> Tuple[Tuple[int, ...], ...]:
    """All injective ref->pred assignments, in the reference's scan order.

    Order matters for tie-breaking parity: the reference iterates
    combinations(range(N), K) x permutations(range(K)) and keeps the first
    strict maximum (reference: overlap3_core.py:81-97).
    """
    out = []
    for cols in itertools.combinations(range(n_preds), k_refs):
        for perm in itertools.permutations(range(k_refs)):
            # assignment[i] = pred column chosen for ref i
            out.append(tuple(cols[perm.index(i)] for i in range(k_refs)))
    return tuple(out)


def pit_best_si_sdr(
    refs: Sequence[np.ndarray], preds: Sequence[np.ndarray]
) -> Tuple[float, List[int]]:
    """Best mean SI-SDR over injective ref->pred assignments.

    Returns (best_mean_sdr, [pred index per ref]); (nan, []) when fewer
    preds than refs or no valid assignment
    (reference: overlap3_core.py:66-100).
    """
    k = len(refs)
    if k not in (2, 3):
        raise ValueError("pit_best_si_sdr supports K=2 or 3")
    if len(preds) < k:
        return float("nan"), []
    sdr_mat = np.array([[si_sdr(r, p) for p in preds] for r in refs], dtype=np.float64)
    best = -1e9
    best_idx: List[int] = []
    for assign in _assignments(len(preds), k):
        vals = sdr_mat[np.arange(k), list(assign)]
        if np.isnan(vals).any():
            continue
        mean_sdr = float(vals.mean())
        if mean_sdr > best:
            best = mean_sdr
            best_idx = list(assign)
    if not best_idx:
        return float("nan"), []
    return float(best), best_idx


def pit_best_si_sdr_2(
    refs: Sequence[np.ndarray], preds: Sequence[np.ndarray]
) -> Tuple[float, List[int], bool]:
    """2-reference PIT that also reports the `swapped` flag
    (reference: evaluate_with_sources.py:334-374): scan ordered pred-column
    pairs (j, k), compare direct vs swapped matching on those columns."""
    assert len(refs) == 2, "This PIT helper expects exactly 2 references."
    if len(preds) < 2:
        return float("nan"), [], False
    sdr1 = [si_sdr(refs[0], p) for p in preds]
    sdr2 = [si_sdr(refs[1], p) for p in preds]
    best = -1e9
    best_pair = (-1, -1)
    best_swapped = False
    n = len(preds)
    for j in range(n):
        for k in range(n):
            if j == k:
                continue
            sdr_12 = 0.5 * (sdr1[j] + sdr2[k])
            sdr_21 = 0.5 * (sdr1[k] + sdr2[j])
            cur, swapped = (sdr_12, False) if sdr_12 >= sdr_21 else (sdr_21, True)
            if cur > best:
                best = cur
                best_pair = (j, k)
                best_swapped = swapped
    return float(best), [best_pair[0], best_pair[1]], best_swapped


def sdr_improvement_pit_2(
    mix_chunk: np.ndarray, s1_ref: np.ndarray, s2_ref: np.ndarray, preds: Sequence[np.ndarray]
) -> Tuple[float, float, List[int], bool]:
    """(best, improvement, indices, swapped) for the 2-ref evaluator path
    (reference: evaluate_with_sources.py:377-393)."""
    import math

    base = 0.5 * (si_sdr(s1_ref, mix_chunk) + si_sdr(s2_ref, mix_chunk))
    best, indices, swapped = pit_best_si_sdr_2([s1_ref, s2_ref], preds)
    if math.isnan(best):
        return float("nan"), float("nan"), [], False
    return best, best - base, indices, swapped


def sdr_improvement_pit(
    mix_chunk: np.ndarray, refs: Sequence[np.ndarray], preds: Sequence[np.ndarray]
) -> Tuple[float, float, List[int]]:
    """(best SI-SDR, SI-SDRi vs the mixture baseline, chosen indices).

    Baseline is the mean SI-SDR of each ref against the raw mixture
    (reference: overlap3_core.py:103-117).
    """
    if len(refs) not in (2, 3):
        return float("nan"), float("nan"), []
    base_vals = [si_sdr(r, mix_chunk) for r in refs]
    if any(np.isnan(v) for v in base_vals):
        return float("nan"), float("nan"), []
    base = float(np.mean(base_vals))
    best, indices = pit_best_si_sdr(refs, preds)
    if np.isnan(best):
        return float("nan"), float("nan"), []
    return float(best), float(best - base), indices


# ---------------------------------------------------------------------------
# device (batched, masked) implementations
# ---------------------------------------------------------------------------


def _masked_zero_mean(x: torch.Tensor, mask: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    mean = (x * mask).sum(dim=-1, keepdim=True) / count[..., None]
    return (x - mean) * mask


def si_sdr_matrix(refs: torch.Tensor, preds: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Pairwise SI-SDR on device.

    refs [B, K, T], preds [B, N, T], mask [B, T] (1 on valid samples)
    -> [B, K, N] SI-SDR in dB. Zero-energy refs give large-negative values
    rather than NaN so downstream max/argmax stay well-defined.
    """
    mask = mask.float()
    m = mask[:, None, :]
    count = torch.clamp_min(mask.sum(dim=-1), 1.0)[:, None]
    r = _masked_zero_mean(refs.float(), m, count)
    e = _masked_zero_mean(preds.float(), m, count)
    dots = torch.einsum("bkt,bnt->bkn", r, e)  # [B, K, N]
    ref_energy = (r * r).sum(dim=-1) + 1e-12  # [B, K]
    est_energy = (e * e).sum(dim=-1) + 1e-12  # [B, N]
    scale = dots / ref_energy[..., None]  # [B, K, N]
    # ||proj||^2 = scale^2 ||ref||^2; ||noise||^2 = ||est||^2 - 2 scale <est,ref> + scale^2 ||ref||^2
    proj_e = scale * scale * ref_energy[..., None] + 1e-12
    noise_e = (est_energy[:, None, :] - 2.0 * scale * dots
               + scale * scale * ref_energy[..., None] + 1e-12)
    noise_e = torch.clamp_min(noise_e, 1e-12)
    sdr = 10.0 * torch.log10(proj_e / noise_e)
    valid_ref = ((refs * m) != 0.0).sum(dim=-1) > 0  # [B, K]
    return torch.where(valid_ref[..., None], sdr, torch.full_like(sdr, -1e9))


def pit_si_sdr_batch(refs: torch.Tensor, preds: torch.Tensor, mask: torch.Tensor,
                     k_refs: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched PIT over a static assignment enumeration.

    refs [B, Kmax, T] (only first k_refs rows used), preds [B, N, T],
    mask [B, T] -> (best mean SDR [B], assignment indices [B, k_refs]).
    """
    n = preds.shape[1]
    sdr = si_sdr_matrix(refs[:, :k_refs], preds, mask)  # [B, K, N]
    assigns = torch.tensor(_assignments(n, k_refs), dtype=torch.long, device=sdr.device)  # [M, K]
    picked = sdr[:, torch.arange(k_refs, device=sdr.device)[None, :], assigns]  # [B, M, K]
    scores = picked.mean(dim=-1)  # [B, M]
    best, best_m = scores.max(dim=-1)
    return best, assigns[best_m]


def sdr_improvement_pit_batch(mix: torch.Tensor, refs: torch.Tensor, preds: torch.Tensor,
                              mask: torch.Tensor, k_refs: int
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched (best, improvement, indices): device analog of
    ``sdr_improvement_pit`` for one padded bucket of overlap segments.

    mix [B, T]; refs [B, Kmax, T]; preds [B, N, T]; mask [B, T].
    """
    base_mat = si_sdr_matrix(refs[:, :k_refs], mix[:, None, :], mask)  # [B, K, 1]
    base = base_mat[..., 0].mean(dim=-1)  # [B]
    best, idx = pit_si_sdr_batch(refs, preds, mask, k_refs)
    return best, best - base, idx
