"""Port parity for the quantized DiT under tensor parallelism: gloo
worlds of the port at tp = 2 and (sp = 2, tp = 2) against the jitted JAX
package on its virtual mesh (the helpers and the rules, the JAX codes
shared with each W8A8 product included, are test_torch_parallel_quant's),
fp32, within 1e-4 * max, every rank the same numbers: calibrate=True, the
five quantize modes (int8 and grouped int4 weight-only, W8A8 dynamic and
calibrated on the world's own statistics, W4A8) with each tp rank's codes
and scales cut (ffn_out's int4 groups straddled), and at tp = 2 the
TeaCache record pass through the sharded pipeline."""

import numpy as np

from test_torch_parallel import trees  # noqa: F401 (fixture)
from test_torch_parallel_quant import (
    BAR, MODES, _calib, _check_forward, _check_record, _check_stats, _inputs, _qdit,
    _record, _rel_err, _tree_arrays)
from tests.jax_prng import threefry_default  # noqa: F401
from tests.torch_mesh import run_world
from versecrafter_tpu.core import mesh as jmesh
from versecrafter_tpu.utils import quantize as jq


def _tp_world(spec, tmp_path, seed, jp=None):
    """calibrate=True, then the five modes (the calibrated one on the scales
    fitted from this world's own statistics, the JAX one on the JAX
    package's), W4A8 also quantized after sharding; with the `trees`
    fixture `jp`, the TeaCache record pass."""
    params, a, arrays = _inputs("q", seed)
    c, cal_out, cal_stats = _calib("cal", "q", spec, params, a)
    cases, want = [c], {"cal": (cal_out, None)}
    for mode in MODES:
        static = mode == "w8a8_static"
        c, codes, w, rec = _qdit(mode, "q", mode, spec, params, a,
                                 scales=jq.fit_act_scales([cal_stats]) if static else None,
                                 orders=mode == "w4a8",
                                 **({"scales_from": "cal"} if static else {}))
        cases.append(c)
        arrays.update(codes)
        want[mode] = (w, rec)
    if jp is not None:
        c, rec_arrays, ref, latents = _record("rec", spec, jp, np.random.default_rng(8))
        cases.append(c)
        arrays.update(rec_arrays)
        arrays.update(_tree_arrays(jp))
    outs = run_world(spec.size, {"spec": list(spec.shape), "cases": cases}, arrays, tmp_path)
    for name, (w, rec) in want.items():
        _check_forward(outs, name, w, rec)
    for out in outs:
        # ffn_in's columns and ffn_out's rows cut over tp (int4: packed rows)
        tp = spec.tp
        for mode, (bits, _) in MODES.items():
            pack = 2 if bits == 4 else 1
            assert out[f"{mode}.shape/ffn_in"].tolist() == [128 // pack, 384 // tp], mode
            assert out[f"{mode}.shape/ffn_out"].tolist() == [384 // pack // tp, 128], mode
            assert out[f"{mode}.shape/o"].tolist() == [128 // pack // tp, 128], mode
    assert bool(outs[0]["w4a8.orders_equal"])
    names = list(MODES)
    for i, m in enumerate(names):  # each mode is its own quantization
        for n in names[i + 1:]:
            assert _rel_err(outs[0][m + ".out"], outs[0][n + ".out"]) > BAR, (m, n)
    _check_stats(outs, "cal", cal_stats)
    if jp is not None:
        _check_record(outs, "rec", ref, latents)


def test_quantized_tp2_world_matches_jax(trees, tmp_path):  # noqa: F811
    """tp = 2: calibrate=True, the five modes (the calibrated one on the
    scales fitted from this world's own statistics), W4A8 also quantized
    after sharding, and the TeaCache record pass."""
    _tp_world(jmesh.MeshSpec(tp=2), tmp_path, 2, trees)


def test_quantized_sp2tp2_world_matches_jax(tmp_path):
    """(sp = 2, tp = 2): calibrate=True and the five modes over Ulysses."""
    _tp_world(jmesh.MeshSpec(sp=2, tp=2), tmp_path, 3)
