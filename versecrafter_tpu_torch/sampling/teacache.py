"""TeaCache: timestep-embedding-aware skipping of the DiT's blocks.

A polynomial-rescaled relative L1 distance of the time-modulation tensor e0
accumulates across steps; while the accumulator stays below the threshold
the transformer blocks are skipped and the previous residual (blocks output
minus blocks input) is reused. The first `skip_start` steps never skip, and
a step that runs the blocks resets its accumulator. Rows (the CFG branches)
keep separate accumulators and decide independently.

Eagerly, the JAX package's lax.cond becomes one host read of the per-row
decision per step: the blocks run once for the whole batch when any row
calculates, each skipping row takes its tokens plus its own cached residual,
and the residual and the accumulator advance only where the row calculated.
Above TEA_RES_QUANT_ROWS rows the residual is stored int8 with per-token
scales; above TEA_RECORD_SUBSAMPLE_ROWS the record pass tracks a strided
row subset. host_gate is the same decision in float64 numpy on the host,
which sequential CFG above TEA_HOST_GATE_ROWS rows uses, as the JAX
package does.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from versecrafter_tpu_torch.parallel.sharding import local_rows

# rescale polynomial for Wan / VerseCrafter 14B, highest power first
VERSECRAFTER_COEFFS = (
    8.10705460e03, 2.13393892e03, -3.72934672e02, 1.66203073e01, -4.17769401e-02
)

# B*S rows above which the cached residual is stored int8 (per-token
# scales); CFG-2 at 480x832x81 (65,520 rows) stays exact bf16
TEA_RES_QUANT_ROWS = 70_000
# B*S rows above which the record pass keeps every RECORD_SUBSAMPLE_STRIDE-th
# token row only
TEA_RECORD_SUBSAMPLE_ROWS = 70_000
RECORD_SUBSAMPLE_STRIDE = 16
# B*S rows above which sequential-CFG generations take the skip decision on
# the host (host_gate) from the e0 trajectory
TEA_HOST_GATE_ROWS = 70_000


class TeaCacheState(NamedTuple):
    prev_mod: torch.Tensor       # [B, 6, D] fp32, the previous e0
    prev_residual: object        # [B, S, D], or {"q": int8 [B, S, D],
    #                              "scale": fp32 [B, S, 1]} when int8-stored
    accum: torch.Tensor          # [B] fp32 accumulated rescaled distance
    valid: torch.Tensor          # [B] bool, prev_mod / residual populated


class HostTeaState:
    """The host gate's decision state (prev_mod, accum, valid) in numpy;
    the residual stays on the device."""

    def __init__(self, batch: int, dim: int):
        self.prev_mod = np.zeros((batch, 6, dim), np.float32)
        self.accum = np.zeros((batch,), np.float32)
        self.valid = np.zeros((batch,), bool)


def host_gate(state: HostTeaState, e0: np.ndarray, step_index: int,
              threshold: float, skip_start: int = 5,
              coefficients=VERSECRAFTER_COEFFS) -> np.ndarray:
    """gated_blocks' per-row decision on the host (the polynomial in float64
    np.polyval); advances `state` and returns should_calc [B] bool."""
    e0 = np.asarray(e0, np.float32)
    rel = (np.abs(e0 - state.prev_mod).mean(axis=(1, 2))
           / np.maximum(np.abs(state.prev_mod).mean(axis=(1, 2)), 1e-8))
    accum = state.accum + np.polyval(np.asarray(coefficients, np.float64),
                                     rel).astype(np.float32)
    must = (step_index < skip_start) | ~state.valid
    should = must | (accum >= threshold)
    state.accum = np.where(should, 0.0, accum).astype(np.float32)
    state.prev_mod = e0
    state.valid = np.ones_like(state.valid)
    return should


def _store_residual(res: torch.Tensor, quantize: bool):
    if not quantize:
        return res
    f = res.float()
    scale = torch.clamp(f.abs().amax(dim=-1, keepdim=True), min=1e-8) / 127.0
    return {"q": torch.clamp(torch.round(f / scale), -127, 127).to(torch.int8),
            "scale": scale}


def _load_residual(stored, dtype):
    if isinstance(stored, dict):
        return (stored["q"].float() * stored["scale"]).to(dtype)
    return stored.to(dtype)


def res_shape(state: TeaCacheState):
    """[B, S, D] of the cached residual, whatever its storage."""
    r = state.prev_residual
    return tuple((r["q"] if isinstance(r, dict) else r).shape)


def init_state(batch: int, seq: int, dim: int, dtype=torch.bfloat16,
               quantize_residual: Optional[bool] = None, device=None) -> TeaCacheState:
    if quantize_residual is None:
        quantize_residual = batch * seq > TEA_RES_QUANT_ROWS
    if quantize_residual:
        res = {"q": torch.zeros((batch, seq, dim), dtype=torch.int8, device=device),
               "scale": torch.full((batch, seq, 1), 1e-8 / 127.0, dtype=torch.float32,
                                   device=device)}
    else:
        res = torch.zeros((batch, seq, dim), dtype=dtype, device=device)
    return TeaCacheState(
        prev_mod=torch.zeros((batch, 6, dim), dtype=torch.float32, device=device),
        prev_residual=res,
        accum=torch.zeros((batch,), dtype=torch.float32, device=device),
        valid=torch.zeros((batch,), dtype=torch.bool, device=device))


def slice_rows(state: TeaCacheState, rows: slice) -> TeaCacheState:
    """The state of a subset of its rows (the cond half when cfg-skip
    starts)."""
    r = state.prev_residual
    return TeaCacheState(
        prev_mod=state.prev_mod[rows],
        prev_residual=({k: v[rows] for k, v in r.items()} if isinstance(r, dict)
                       else r[rows]),
        accum=state.accum[rows], valid=state.valid[rows])


def _poly(coeffs, x):
    """Horner's rule in x's dtype (fp32), as gated_blocks' device arithmetic."""
    acc = torch.zeros_like(x)
    for c in coeffs:
        acc = acc * x + c
    return acc


def _rel_l1(cur: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Per-row mean|cur - prev| / max(mean|prev|, 1e-8)."""
    dims = tuple(range(1, cur.dim()))
    return ((cur - prev).abs().mean(dim=dims)
            / torch.clamp(prev.abs().mean(dim=dims), min=1e-8))


def apply_gate(run_blocks: Callable[[torch.Tensor], torch.Tensor],
               tokens: torch.Tensor, prev_residual, should_calc: torch.Tensor):
    """(tokens out, residual) for a per-row decision should_calc [B] bool,
    read once on the host: the blocks run once for the batch when any row
    calculates; a row that skips takes tokens + its cached residual and keeps
    that residual; a row that calculates takes the fresh tokens and stores
    fresh - tokens (int8 when the cache is)."""
    calc = should_calc.cpu()
    quantized = isinstance(prev_residual, dict)
    if not bool(calc.any()):
        return tokens + _load_residual(prev_residual, tokens.dtype), prev_residual
    fresh = run_blocks(tokens)
    diff = fresh - tokens
    new_res = _store_residual(diff if quantized else diff.to(prev_residual.dtype), quantized)
    del diff
    if bool(calc.all()):
        return fresh, new_res
    # the decision is over every row; under a mesh tokens hold this rank's
    sel = local_rows(should_calc.to(tokens.device))[:, None, None]
    out = torch.where(sel, fresh, tokens + _load_residual(prev_residual, tokens.dtype))
    if quantized:
        return out, {k: torch.where(sel, new_res[k], prev_residual[k]) for k in new_res}
    return out, torch.where(sel, new_res, prev_residual)


def gated_blocks(run_blocks: Callable[[torch.Tensor], torch.Tensor],
                 tokens: torch.Tensor, e0: torch.Tensor, state: TeaCacheState,
                 step_index: int, threshold: float, skip_start: int = 5,
                 coefficients=VERSECRAFTER_COEFFS) -> Tuple[torch.Tensor, TeaCacheState]:
    """The blocks section behind the TeaCache gate: run_blocks maps tokens
    to tokens. Returns (tokens out, new state); the rows decide on the
    device's fp32 arithmetic (the polynomial by Horner's rule)."""
    accum = state.accum + _poly(coefficients, _rel_l1(e0, state.prev_mod))
    must = (step_index < skip_start) | ~state.valid
    should = must | (accum >= threshold)
    out, residual = apply_gate(run_blocks, tokens, state.prev_residual, should)
    return out, TeaCacheState(
        prev_mod=e0.float(), prev_residual=residual,
        accum=torch.where(should, torch.zeros_like(accum), accum),
        valid=torch.ones_like(state.valid))


def fit_teacache_coefficients(rel_e0, rel_residual, degree: int = 4):
    """Fit the rescale polynomial (highest power first, usable as
    `coefficients=`) from recorded per-step observations of the e0 drift and
    the blocks-residual drift (VerseCrafterPipeline.record_teacache_stats),
    pooled over prompts and seeds."""
    x = np.asarray(rel_e0, np.float64).ravel()
    y = np.asarray(rel_residual, np.float64).ravel()
    ok = np.isfinite(x) & np.isfinite(y)
    if ok.sum() <= degree:
        raise ValueError(
            f"need more than {degree} finite observations, got {int(ok.sum())}")
    return tuple(np.polyfit(x[ok], y[ok], degree))


def recording_blocks(run_blocks, tokens: torch.Tensor, e0: torch.Tensor,
                     state: TeaCacheState):
    """The always-run counterpart of gated_blocks that measures what the gate
    observes: new_state.accum is the per-row relative L1 drift of the blocks
    residual against the previous step's, prev_mod snapshots e0. A state
    with fewer residual rows than tokens (init_state seq = ceil(S / stride))
    tracks every stride-th token row; the stride follows from the shapes."""
    quantized = isinstance(state.prev_residual, dict)
    fresh = run_blocks(tokens)
    s_full = tokens.shape[1]
    s_sub = res_shape(state)[1]
    stride = max(1, round(s_full / s_sub)) if s_sub else 1
    if s_sub and -(-s_full // stride) != s_sub:
        raise ValueError(f"record state rows {s_sub} are not a ceil-strided subset of "
                         f"sequence {s_full}")
    residual = (fresh[:, ::stride] - tokens[:, ::stride] if stride > 1
                else fresh - tokens)
    rel_res = _rel_l1(residual.float(), _load_residual(state.prev_residual, torch.float32))
    return fresh, TeaCacheState(
        prev_mod=e0.float(),
        prev_residual=_store_residual(
            residual if quantized else residual.to(state.prev_residual.dtype), quantized),
        accum=rel_res, valid=torch.ones_like(state.valid))
