"""Port parity for TeaCache, cfg-skip and sequential CFG: the port's
sampling/teacache.py against the JAX module on the same numpy inputs with a
deterministic run_blocks, and the port's pipeline against the JAX pipeline
(the tiny pipelines of tests/test_torch_pipeline.py) with TeaCache on under
batched CFG, sequential CFG, cfg-skip and the host-gated regime, and the
record-then-fit path (CPU).

A skip decision that sits near its threshold could flip on one rounding, so
every test first asserts that each decision it checks clears the threshold
by a stated margin, and then requires the same skip schedule and results
within 1e-4 * max (fp32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pipeline import _inputs, _rel_err, pipes  # noqa: F401 (fixture)
from versecrafter_tpu.models.wan_dit import wan_dit_e0
from versecrafter_tpu.sampling import pipeline as jpipe
from versecrafter_tpu.sampling import teacache as jtc
from versecrafter_tpu.sampling.schedulers import make_scheduler
from versecrafter_tpu.core.config import SchedulerConfig
from versecrafter_tpu_torch.sampling import pipeline as tpipe
from versecrafter_tpu_torch.sampling import teacache as ttc

BAR = 1e-4
MARGIN = 0.05  # every checked decision clears its threshold by 5 % of it


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _blocks_j(tokens):
    return tokens * 2.0 + 1.0


def _blocks_t(tokens):
    return tokens * 2.0 + 1.0


def _state_pair(batch, seq, dim, seed, valid=True, quantize=False):
    """The same TeaCache state in both packages: random prev_mod (away from
    zero) and residual, accumulators at 0."""
    rng = np.random.default_rng(seed)
    prev_mod = (rng.random((batch, 6, dim)) + 0.5).astype(np.float32)
    res = rng.standard_normal((batch, seq, dim)).astype(np.float32)
    jres = jtc._store_residual(jnp.asarray(res), quantize)
    tres = ttc._store_residual(torch.from_numpy(res), quantize)
    js = jtc.TeaCacheState(prev_mod=jnp.asarray(prev_mod), prev_residual=jres,
                           accum=jnp.zeros((batch,), jnp.float32),
                           valid=jnp.full((batch,), valid))
    ts = ttc.TeaCacheState(prev_mod=torch.from_numpy(prev_mod), prev_residual=tres,
                           accum=torch.zeros(batch), valid=torch.full((batch,), valid))
    return prev_mod, js, ts


def _poly64(rel):
    return np.polyval(np.asarray(ttc.VERSECRAFTER_COEFFS, np.float64), rel)


def _assert_states_equal(got: ttc.TeaCacheState, ref: jtc.TeaCacheState):
    np.testing.assert_allclose(_np(got.prev_mod), np.asarray(ref.prev_mod), rtol=1e-6)
    np.testing.assert_allclose(_np(got.accum), np.asarray(ref.accum), rtol=1e-5)
    np.testing.assert_array_equal(_np(got.valid), np.asarray(ref.valid))
    if isinstance(ref.prev_residual, dict):
        np.testing.assert_array_equal(_np(got.prev_residual["q"]),
                                      np.asarray(ref.prev_residual["q"]))
        np.testing.assert_allclose(_np(got.prev_residual["scale"]),
                                   np.asarray(ref.prev_residual["scale"]), rtol=1e-6)
    else:
        assert _rel_err(got.prev_residual, ref.prev_residual) <= 1e-6


# row factors of e0 against prev_mod, so rel = |factor - 1| per row
GATE_CASES = {
    "rows_decide_apart": dict(batch=2, factors=(1.05, 1.4), step=6, skip_start=5),
    "both_rows_skip": dict(batch=2, factors=(1.05, 1.06), step=6, skip_start=5),
    "skip_start_forces_calc": dict(batch=2, factors=(1.05, 1.06), step=2, skip_start=5),
    "invalid_state_calcs": dict(batch=2, factors=(1.05, 1.4), step=6, skip_start=0,
                                valid=False),
    "int8_residual_rows_apart": dict(batch=2, factors=(1.05, 1.4), step=6, skip_start=5,
                                     quantize=True),
    "batch1_skips": dict(batch=1, factors=(1.05,), step=6, skip_start=5),
    "batch1_calcs_int8": dict(batch=1, factors=(1.4,), step=6, skip_start=5,
                              quantize=True),
}


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_gated_blocks_matches_jax(case):
    c = GATE_CASES[case]
    batch, factors = c["batch"], np.asarray(c["factors"], np.float32)
    seq, dim = 12, 16
    prev_mod, js, ts = _state_pair(batch, seq, dim, seed=1, valid=c.get("valid", True),
                                   quantize=c.get("quantize", False))
    e0 = prev_mod * factors[:, None, None]
    tokens = np.random.default_rng(2).standard_normal((batch, seq, dim)).astype(np.float32)
    # the threshold sits between poly(0.05) and poly(0.4), far from both
    accum = _poly64(np.abs(factors.astype(np.float64) - 1.0))
    threshold = 0.5 * (_poly64(0.05) + _poly64(0.4))
    assert np.all(np.abs(accum - threshold) > MARGIN * abs(threshold))
    ref_out, ref_state = jax.jit(
        lambda tk, e, s: jtc.gated_blocks(_blocks_j, tk, e, s, jnp.asarray(c["step"]),
                                          threshold, c["skip_start"]))(
        jnp.asarray(tokens), jnp.asarray(e0), js)
    got_out, got_state = ttc.gated_blocks(_blocks_t, torch.from_numpy(tokens),
                                          torch.from_numpy(e0), ts, c["step"], threshold,
                                          c["skip_start"])
    assert _rel_err(got_out, ref_out) <= 1e-6
    _assert_states_equal(got_state, ref_state)


def test_gated_blocks_runs_no_blocks_when_every_row_skips():
    _, _, ts = _state_pair(2, 4, 8, seed=3)
    calls = []
    tokens = torch.ones(2, 4, 8)
    out, _ = ttc.gated_blocks(lambda tk: calls.append(1) or tk, tokens,
                              ts.prev_mod * 1.01, ts, 9, 1e9, 0)
    assert calls == []
    assert torch.equal(out, tokens + ts.prev_residual)


@pytest.mark.parametrize("stride", [1, 4])
@pytest.mark.parametrize("quantize", [False, True])
def test_recording_blocks_matches_jax(stride, quantize):
    """Full and row-subsampled (state rows = ceil(S / stride)) record passes."""
    batch, seq, dim = 2, 30, 16  # 30 rows: the subset's last stride is short
    _, js, ts = _state_pair(batch, -(-seq // stride), dim, seed=4, quantize=quantize)
    rng = np.random.default_rng(5)
    tokens = rng.standard_normal((batch, seq, dim)).astype(np.float32)
    e0 = rng.standard_normal((batch, 6, dim)).astype(np.float32)
    ref_out, ref_state = jax.jit(lambda tk, e, s: jtc.recording_blocks(_blocks_j, tk, e, s))(
        jnp.asarray(tokens), jnp.asarray(e0), js)
    got_out, got_state = ttc.recording_blocks(_blocks_t, torch.from_numpy(tokens),
                                              torch.from_numpy(e0), ts)
    assert _rel_err(got_out, ref_out) <= 1e-6
    _assert_states_equal(got_state, ref_state)


def test_recording_rejects_a_state_that_is_no_strided_subset():
    ts = ttc.init_state(1, 5, 4, torch.float32)
    with pytest.raises(ValueError, match="ceil-strided"):
        ttc.recording_blocks(_blocks_t, torch.zeros(1, 12, 4), torch.zeros(1, 6, 4), ts)


def test_host_gate_matches_jax_and_gated_blocks():
    """A trajectory of e0 through both packages' host gates (float64
    polyval) and the port's gated_blocks (fp32 Horner): the same decisions
    and accumulators."""
    rng = np.random.default_rng(6)
    batch, dim, threshold = 2, 16, 8.0
    coeffs = (1.0, 0.0, 2.0, 0.0)  # x^3 + 2x
    jh, th = jtc.HostTeaState(batch, dim), ttc.HostTeaState(batch, dim)
    ts = ttc.init_state(batch, 3, dim, torch.float32)
    e0 = (rng.random((batch, 6, dim)) + 0.5).astype(np.float32)
    pre, decisions = np.zeros(batch), []
    for i in range(8):
        if i:  # row 1 drifts faster; relative drift per step 0.6 / 1.1
            e0 = e0 * np.asarray([1.6, 2.1], np.float32)[:, None, None]
            pre = pre + np.asarray([0.6 ** 3 + 1.2, 1.1 ** 3 + 2.2])
            assert np.all(np.abs(pre - threshold) > MARGIN * threshold), (i, pre)
        ref = jtc.host_gate(jh, e0, i, threshold, 1, coeffs)
        got = ttc.host_gate(th, e0, i, threshold, 1, coeffs)
        _, ts = ttc.gated_blocks(_blocks_t, torch.zeros(batch, 3, dim), torch.from_numpy(e0),
                                 ts, i, threshold, 1, coeffs)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(th.accum, jh.accum)
        np.testing.assert_allclose(ts.accum.numpy(), th.accum, rtol=1e-5)
        pre = np.where(got, 0.0, pre)
        decisions.append(got)
    assert any(d[0] != d[1] for d in decisions)  # the rows decided apart


@pytest.mark.parametrize("rows,quantize", [(8, None), (70_001, None), (8, True),
                                           (70_001, False)])
def test_init_state_matches_jax(rows, quantize):
    """Storage is int8 above TEA_RES_QUANT_ROWS B*S rows unless asked."""
    ref = jtc.init_state(1, rows, 4, jnp.bfloat16, quantize_residual=quantize)
    got = ttc.init_state(1, rows, 4, torch.bfloat16, quantize_residual=quantize)
    assert ttc.res_shape(got) == jtc.res_shape(ref)
    assert isinstance(got.prev_residual, dict) == isinstance(ref.prev_residual, dict)
    if isinstance(ref.prev_residual, dict):
        assert got.prev_residual["q"].dtype == torch.int8
        np.testing.assert_array_equal(got.prev_residual["scale"].numpy(),
                                      np.asarray(ref.prev_residual["scale"]))
    else:
        assert got.prev_residual.dtype == torch.bfloat16
    for name in ("prev_mod", "accum", "valid"):
        np.testing.assert_array_equal(_np(getattr(got, name)),
                                      np.asarray(getattr(ref, name)))


def test_int8_residual_storage_matches_jax():
    res = (np.random.default_rng(7).standard_normal((2, 9, 32)) * 3).astype(np.float32)
    res[1, 4] = 0.0  # an all-zero token keeps its floor scale
    ref = jtc._store_residual(jnp.asarray(res), True)
    got = ttc._store_residual(torch.from_numpy(res), True)
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(ref["q"]))
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(ref["scale"]))
    np.testing.assert_array_equal(ttc._load_residual(got, torch.float32).numpy(),
                                  np.asarray(jtc._load_residual(ref, jnp.float32)))
    assert np.abs(ttc._load_residual(got, torch.float32).numpy() - res).max() \
        <= np.abs(res).max() / 127


def test_fit_coefficients_matches_jax():
    rng = np.random.default_rng(8)
    x = rng.random(40) * 0.3
    y = np.polyval([3.0, -1.0, 0.5], x) + 1e-4 * rng.standard_normal(40)
    y[3] = np.nan  # non-finite observations are dropped
    got = ttc.fit_teacache_coefficients(x, y, degree=2)
    assert got == jtc.fit_teacache_coefficients(x, y, degree=2)
    np.testing.assert_allclose(got, [3.0, -1.0, 0.5], atol=2e-2)
    with pytest.raises(ValueError, match="observations"):
        ttc.fit_teacache_coefficients(x[:2], y[:2], degree=2)


def test_constants_match_jax():
    for name in ("VERSECRAFTER_COEFFS", "TEA_RES_QUANT_ROWS", "TEA_RECORD_SUBSAMPLE_ROWS",
                 "RECORD_SUBSAMPLE_STRIDE", "TEA_HOST_GATE_ROWS"):
        assert getattr(ttc, name) == getattr(jtc, name)


# -- the pipelines -------------------------------------------------------------

STEPS, SHIFT, SKIP_START, THRESHOLD = 6, 3.0, 1, 20000.0


def _expected_schedule(jp, cfg_skip_ratio):
    """The skip decisions this request must take, from the JAX model's e0 at
    its timesteps (float64 polynomial); asserts that each clears the
    threshold by MARGIN. The same for every CFG row (one e0 a step)."""
    ts = make_scheduler("unipc", SchedulerConfig()).set_timesteps(STEPS, shift=SHIFT)
    e0s = [np.asarray(wan_dit_e0(jp.dit_params, jp.dit_cfg,
                                 jnp.full((1,), float(t), jnp.float32)))[0] for t in ts]
    calc, accum = [], 0.0
    for i, e0 in enumerate(e0s):
        if i:
            prev = e0s[i - 1]
            accum += _poly64(np.abs(e0 - prev).mean() / np.abs(prev).mean())
        if i >= SKIP_START:
            assert abs(accum - THRESHOLD) > MARGIN * THRESHOLD, (i, accum)
        calc.append(i < SKIP_START or accum >= THRESHOLD)
        if calc[-1]:
            accum = 0.0
    assert not all(calc) and any(calc[SKIP_START:])  # it skips, and it calculates
    return calc


def _tea_run(pipe, dtype, **kw):
    controls, mask, noise = _inputs()
    return pipe("a car drives left", negative_prompt="static", control_videos=controls,
                mask_video=mask, latents=noise, height=8, width=8, num_frames=5,
                num_inference_steps=STEPS, guidance_scale=2.0, shift=SHIFT, dtype=dtype,
                output_type="latent", **kw)


def _configure(pipe, cfg_parallel, cfg_skip_ratio):
    pipe.enable_teacache(THRESHOLD, SKIP_START)
    pipe.enable_cfg_skip(cfg_skip_ratio)
    pipe.cfg_parallel = cfg_parallel
    pipe.teacache_debug = True


def _reset(pipe):
    pipe.disable_teacache()
    pipe.enable_cfg_skip(0.0)
    pipe.cfg_parallel = True
    pipe.teacache_debug = False


@pytest.mark.parametrize("cfg_parallel,cfg_skip_ratio,host_gated", [
    (True, 0.0, False), (False, 0.0, False), (True, 0.34, False), (False, 0.34, False),
    (False, 0.0, True), (False, 0.34, True)])
def test_teacache_request_matches_jax(pipes, monkeypatch, cfg_parallel, cfg_skip_ratio,
                                      host_gated):
    """The same skip schedule (teacache_accum_history) and latents within
    1e-4 * max. Batched CFG gates both rows of one forward; sequential CFG
    runs two batch-1 forwards with separate states (the uncond state frozen
    in the cfg-skip window); the host-gated regime (TEA_HOST_GATE_ROWS set
    below the request's rows in both packages) decides on the host."""
    jp, tp = pipes
    if host_gated:
        monkeypatch.setattr(jtc, "TEA_HOST_GATE_ROWS", 0)
        monkeypatch.setattr(ttc, "TEA_HOST_GATE_ROWS", 0)
    calc = _expected_schedule(jp, cfg_skip_ratio)
    blocks_runs = []
    real_blocks = tpipe.wan_dit_blocks
    monkeypatch.setattr(tpipe, "wan_dit_blocks",
                        lambda *a, **k: blocks_runs.append(1) or real_blocks(*a, **k))
    try:
        for pipe in (jp, tp):
            _configure(pipe, cfg_parallel, cfg_skip_ratio)
        ref = _tea_run(jp, jnp.float32)
        got = _tea_run(tp, torch.float32)
        hist_j, hist_t = jp.teacache_accum_history, tp.teacache_accum_history
    finally:
        for pipe in (jp, tp):
            _reset(pipe)
    assert _rel_err(got, ref) <= BAR
    assert len(hist_t) == len(hist_j) == STEPS
    for i, (a, b) in enumerate(zip(hist_t, hist_j)):
        np.testing.assert_array_equal(a == 0.0, np.asarray(b) == 0.0, err_msg=f"step {i}")
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=0)
        assert bool(np.all(a == 0.0)) == calc[i], f"step {i}"
    # the blocks run once a step that calculates under batched CFG, once a
    # branch under sequential CFG, and never on a skipped step
    skip_from = STEPS * (1.0 - cfg_skip_ratio)
    evaluations = [1 if cfg_parallel or i >= skip_from else 2 for i in range(STEPS)]
    assert len(blocks_runs) == sum(n for n, c in zip(evaluations, calc) if c)


@pytest.mark.parametrize("subsampled", [False, True])
@pytest.mark.parametrize("cfg_parallel", [True, False])
def test_record_then_fit_matches_jax(pipes, monkeypatch, subsampled, cfg_parallel):
    """record_teacache_stats in both packages (the record state row-
    subsampled when TEA_RECORD_SUBSAMPLE_ROWS is set below the request's
    rows), its recorded latents, and the fit on what it recorded."""
    jp, tp = pipes
    if subsampled:
        monkeypatch.setattr(jtc, "TEA_RECORD_SUBSAMPLE_ROWS", 0)
        monkeypatch.setattr(ttc, "TEA_RECORD_SUBSAMPLE_ROWS", 0)
    controls, mask, noise = _inputs()
    kw = dict(negative_prompt="static", control_videos=controls, mask_video=mask,
              latents=noise, height=8, width=8, num_frames=5, num_inference_steps=STEPS,
              guidance_scale=2.0, shift=SHIFT)
    try:
        for pipe in (jp, tp):
            pipe.cfg_parallel = cfg_parallel
            pipe.enable_teacache(0.3)  # recording runs ungated and restores it
            pipe.enable_cfg_skip(0.5)
        ref = jp.record_teacache_stats("a car drives left", dtype=jnp.float32, **kw)
        got = tp.record_teacache_stats("a car drives left", dtype=torch.float32, **kw)
        assert (tp.teacache_threshold, tp.cfg_skip_ratio, tp.teacache_record) == \
            (0.3, 0.5, None)
        assert _rel_err(tp.last_record_latents, jp.last_record_latents) <= BAR
    finally:
        for pipe in (jp, tp):
            _reset(pipe)
    rows = 2 if cfg_parallel else 1
    for g, r in zip(got, ref):
        assert g.shape == np.asarray(r).shape == (STEPS - 1, rows)
        np.testing.assert_allclose(g, np.asarray(r), rtol=1e-4)
    x = np.concatenate([got[0].ravel()] * 2)
    y = np.concatenate([got[1].ravel()] * 2)
    fit = ttc.fit_teacache_coefficients(x, y, degree=1)
    fit_ref = jtc.fit_teacache_coefficients(np.asarray(ref[0]).ravel().repeat(2),
                                            np.asarray(ref[1]).ravel().repeat(2), degree=1)
    np.testing.assert_allclose(np.polyval(fit, x), np.polyval(fit_ref, x), rtol=1e-3)
