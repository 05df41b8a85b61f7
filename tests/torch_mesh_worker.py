"""One rank of a gloo world that runs the port's parallel paths (see
tests/torch_mesh.py). Imports torch and the port only.

    python tests/torch_mesh_worker.py job.json     (under torchrun's env)

The job names a MeshSpec and a list of cases; the inputs are one .npz of
flattened trees. Each rank writes its outputs to <out_dir>/rank<r>.npz. A
job with "serve" runs a model server over the world instead, one with
"cli" the generate CLI.
"""

import datetime
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from versecrafter_tpu_torch.core import config as tconfig  # noqa: E402
from versecrafter_tpu_torch.core.convert import params_from_jax  # noqa: E402
from versecrafter_tpu_torch.core.mesh import MeshSpec, make_mesh  # noqa: E402
from versecrafter_tpu_torch.parallel import sharding as shd  # noqa: E402
from versecrafter_tpu_torch.utils.cache import maybe_init_distributed  # noqa: E402


def _lists(tree):
    if not isinstance(tree, dict):
        return tree
    if tree and all(k.isdigit() for k in tree):
        return [_lists(tree[k]) for k in sorted(tree, key=int)]
    return {k: _lists(v) for k, v in tree.items()}


def unflatten(arrays, prefix):
    """The nested tree of the entries under `prefix/` (a dict whose keys are
    all indices becomes a list)."""
    tree = {}
    for key, val in arrays.items():
        if not key.startswith(prefix + "/"):
            continue
        node = tree
        parts = key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return _lists(tree)


def _cfg(cls, d):
    return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _np(t):
    return t.detach().float().numpy()


def _whole(t):
    """A leaf of this rank's tree made whole (gathered over its axes)."""
    return shd.gathered(t).detach()


COUNTS = {}


def _count(name):
    """Count the calls of sharding.<name> in COUNTS."""
    real = getattr(shd, name)

    def wrapped(*a, **k):
        COUNTS[name] = COUNTS.get(name, 0) + 1
        return real(*a, **k)
    setattr(shd, name, wrapped)


for _name in ("ulysses_attention", "ring_sp_attention"):
    _count(_name)

# whether each shard_vae_io call cut the width (False: left whole)
VAE_SHARDED = []
_real_shard_vae_io = shd.shard_vae_io


def _shard_vae_io(*a, **k):
    x, width = _real_shard_vae_io(*a, **k)
    VAE_SHARDED.append(width is not None)
    return x, width


shd.shard_vae_io = _shard_vae_io


def case_dit(c, arr, mesh, out):
    """The DiT forward; c['ffn_chunk_rows'] lowers wan_dit.FFN_CHUNK_ROWS
    for it. Also the most rows one block FFN call took."""
    from versecrafter_tpu_torch.models import wan_dit as twan
    n = c["name"]
    cfg = _cfg(tconfig.WanDiTConfig, c["cfg"])
    params = shd.shard_dit_params(params_from_jax(unflatten(arr, n + ".params")), mesh)
    COUNTS.clear()
    g = _t(arr[n + ".g"]) if n + ".g" in arr else None
    extras = {k: _t(arr[f"{n}.{k}"]) for k in ("y", "clip_fea", "y_camera")
              if f"{n}.{k}" in arr}
    ffn_rows, real_ffn, real_chunk = [], twan._ffn, twan.FFN_CHUNK_ROWS
    fused, real_fused = [], twan.fused_rope_rms_attention
    twan._ffn = lambda p, x: ffn_rows.append(x.shape[:-1].numel()) or real_ffn(p, x)
    twan.fused_rope_rms_attention = lambda *a, **k: fused.append(1) or real_fused(*a, **k)
    twan.FFN_CHUNK_ROWS = c.get("ffn_chunk_rows", real_chunk)
    try:
        with shd.mesh_context(mesh):
            y = twan.wan_dit_forward(params, cfg, _t(arr[n + ".x"]), _t(arr[n + ".t"]),
                                     _t(arr[n + ".ctx"]), _t(arr[n + ".cos"]),
                                     _t(arr[n + ".sin"]), geoada_context=g, **extras)
    finally:
        twan._ffn, twan.FFN_CHUNK_ROWS = real_ffn, real_chunk
        twan.fused_rope_rms_attention = real_fused
    out[n + ".out"] = _np(y)
    out[n + ".ffn_rows"] = np.int64(max(ffn_rows))
    out[n + ".ulysses"] = np.int64(COUNTS.get("ulysses_attention", 0))
    out[n + ".ring"] = np.int64(COUNTS.get("ring_sp_attention", 0))
    out[n + ".fused"] = np.int64(len(fused))


def _sp_shard(x, mesh):
    return x.chunk(mesh.shape["sp"], dim=2)[mesh.coord["sp"]].contiguous()


def case_ring(c, arr, mesh, out):
    """Ring forward and backward on this rank's sequence shards."""
    from versecrafter_tpu_torch.kernels.ring_attention import ring_attention
    n = c["name"]
    q, k, v = (_sp_shard(_t(arr[f"{n}.{s}"]), mesh).requires_grad_(True) for s in "qkv")
    o = ring_attention(q, k, v, mesh.group("sp"), mesh.global_ranks("sp"))
    o.backward(_sp_shard(_t(arr[n + ".do"]), mesh))
    out.update({n + ".o": _np(o), n + ".dq": _np(q.grad), n + ".dk": _np(k.grad),
                n + ".dv": _np(v.grad)})


def case_ulysses(c, arr, mesh, out):
    n = c["name"]
    q, k, v = (_sp_shard(_t(arr[f"{n}.{s}"]), mesh) for s in "qkv")
    with shd.mesh_context(mesh):
        out[n + ".o"] = _np(shd.ulysses_attention(q, k, v))


def case_dispatch(c, arr, mesh, out):
    """Which path sequence_parallel_attention takes, and its refusal of a
    window on the ring path."""
    n = c["name"]
    q, k, v = (_sp_shard(_t(arr[f"{n}.{s}"]), mesh) for s in "qkv")
    COUNTS.clear()
    with shd.mesh_context(mesh):
        out[n + ".o"] = _np(shd.sequence_parallel_attention(q, k, v))
        refusal = ""
        try:
            shd.sequence_parallel_attention(q, k, v, window_size=(4, 4))
        except NotImplementedError as e:
            refusal = str(e)
    out[n + ".ring"] = np.int64(COUNTS.get("ring_sp_attention", 0))
    out[n + ".ulysses"] = np.int64(COUNTS.get("ulysses_attention", 0))
    out[n + ".refusal"] = np.array(refusal)


def case_t5(c, arr, mesh, out):
    from versecrafter_tpu_torch.models.t5 import t5_encode
    n = c["name"]
    cfg = _cfg(tconfig.T5Config, c["cfg"])
    params = shd.shard_t5_params(params_from_jax(unflatten(arr, n + ".params")), mesh)
    out[n + ".sharded"] = np.int64(sum(
        shd.is_sharded(t) for t in _leaves(params)))
    with shd.mesh_context(mesh):
        out[n + ".out"] = _np(t5_encode(params, cfg, _t(arr[n + ".ids"]), _t(arr[n + ".mask"])))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _flat(tree, prefix):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    res = {}
    for k, v in items:
        res.update(_flat(v, f"{prefix}/{k}"))
    return res


def case_train(c, arr, mesh, out):
    """One GeoAdapter train step (or c['steps']) on the sharded tree; the
    loss and the trained leaves made whole."""
    from versecrafter_tpu_torch.parallel import train_step as tts
    from versecrafter_tpu_torch.utils import prng
    n = c["name"]
    cfg = _cfg(tconfig.WanDiTConfig, c["cfg"])
    params = shd.shard_dit_params(params_from_jax(unflatten(arr, n + ".params")), mesh)
    train, _ = tts.split_trainable(params)
    step = tts.make_train_step(cfg, tts.make_optimizer(train, c["lr"], c["weight_decay"]))
    args = [_t(arr[f"{n}.{s}"]) for s in ("x0", "ctx", "cos", "sin", "geo")]
    losses = []
    with shd.mesh_context(mesh):
        for i in range(c.get("steps", 1)):
            losses.append(float(step(params, *args[:4], args[4], key=prng.key(c["seed"] + i))))
        for k, t in _flat(train, "").items():
            out[n + ".train" + k] = _np(_whole(t))
            g = t.grad
            if shd.is_sharded(t):
                setattr(g, shd.SPEC_ATTR, getattr(t, shd.SPEC_ATTR))
            out[n + ".grad" + k] = _np(_whole(g))
    out[n + ".loss"] = np.asarray(losses, np.float64)


def case_pipeline(c, arr, mesh, out):
    """A request through the sharded pipeline with TeaCache and cfg-skip:
    the latents, the cond accumulator after every step and the count of
    blocks passes; with c['frames'] also the latents decoded (fp32
    frames), and whether that decode ran on width slices."""
    from versecrafter_tpu_torch.sampling import pipeline as tpipe
    from versecrafter_tpu_torch.utils.tokenizer import HashTokenizer
    n = c["name"]
    cfgs = {k: _cfg(getattr(tconfig, cls), c[k]) for k, cls in (
        ("dit_cfg", "WanDiTConfig"), ("vae_cfg", "VAEConfig"), ("t5_cfg", "T5Config"))}
    pipe = tpipe.VerseCrafterPipeline(
        dit_params=params_from_jax(unflatten(arr, n + ".dit")),
        vae_params=params_from_jax(unflatten(arr, n + ".vae")),
        t5_params=params_from_jax(unflatten(arr, n + ".t5")),
        tokenizer=HashTokenizer(cfgs["t5_cfg"].vocab), scheduler_name="unipc",
        device="cpu", mesh=mesh, **cfgs)
    pipe.enable_teacache(c["threshold"], c["skip_start"])
    pipe.enable_cfg_skip(c["cfg_skip_ratio"])
    pipe.teacache_debug = True
    runs = []
    real = tpipe.wan_dit_blocks
    tpipe.wan_dit_blocks = lambda *a, **k: runs.append(1) or real(*a, **k)
    lat = pipe("a car drives left", negative_prompt="static",
               control_videos=[arr[f"{n}.control{i}"] for i in range(2)],
               mask_video=arr[n + ".mask"], latents=arr[n + ".noise"], height=8, width=8,
               num_frames=5, num_inference_steps=c["steps"], guidance_scale=2.0,
               shift=c["shift"], dtype=torch.float32, output_type="latent")
    out[n + ".latents"] = _np(lat)
    for i, a in enumerate(pipe.teacache_accum_history):
        out[f"{n}.accum/{i}"] = np.asarray(a)
    out[n + ".blocks_runs"] = np.int64(len(runs))
    if c.get("frames"):
        VAE_SHARDED.clear()
        out[n + ".frames"] = pipe.decode_latents(lat)
        out[n + ".frames_sharded"] = np.asarray(VAE_SHARDED)


_VAE_PIPES = {}


def case_vae(c, arr, mesh, out):
    """The pipeline's VAE entry points under the mesh on the tiny fp32 trees
    of c['trees'] (a pipeline case's): 'encode' (_vae_encode of c's x) or
    'decode' (decode_latents of c's z, fp32 frames), through the streaming
    path when c['stream'] (VAE_STREAM_THRESHOLD lowered below the input);
    and whether each shard_vae_io call cut the width."""
    from versecrafter_tpu_torch.sampling import pipeline as tpipe
    from versecrafter_tpu_torch.utils.tokenizer import HashTokenizer
    n, t = c["name"], c["trees"]
    if t not in _VAE_PIPES:
        cfgs = {k: _cfg(getattr(tconfig, cls), c[k]) for k, cls in (
            ("dit_cfg", "WanDiTConfig"), ("vae_cfg", "VAEConfig"), ("t5_cfg", "T5Config"))}
        _VAE_PIPES[t] = tpipe.VerseCrafterPipeline(
            dit_params=params_from_jax(unflatten(arr, t + ".dit")),
            vae_params=params_from_jax(unflatten(arr, t + ".vae")),
            t5_params=params_from_jax(unflatten(arr, t + ".t5")),
            tokenizer=HashTokenizer(cfgs["t5_cfg"].vocab), device="cpu", mesh=mesh, **cfgs)
    pipe = _VAE_PIPES[t]
    pipe.VAE_STREAM_THRESHOLD = 100 if c["stream"] else tpipe.VerseCrafterPipeline.VAE_STREAM_THRESHOLD
    VAE_SHARDED.clear()
    with torch.no_grad():
        if c["op"] == "encode":
            out[n + ".out"] = _np(pipe._vae_encode(_t(arr[n + ".x"])))
        else:
            out[n + ".out"] = pipe.decode_latents(_t(arr[n + ".z"]))
    out[n + ".sharded"] = np.asarray(VAE_SHARDED)


def case_init(c, arr, mesh, out):
    """maybe_init_distributed is idempotent once the group exists."""
    out["init.again"] = np.int64(maybe_init_distributed("cpu"))
    out["init.world"] = np.int64(torch.distributed.get_world_size())
    out["init.coord"] = np.asarray([mesh.coord[a] for a in ("dp", "fsdp", "sp", "tp")])


# calibration statistics of earlier "calib" cases of this world, by name
CALIB = {}


def _quant_flags(c):
    """The job's quantize settings: MIN_SIZE (lowered for the tiny models,
    as the JAX side's) and the per-row / per-tensor dynamic scales."""
    from versecrafter_tpu_torch.utils import quantize as tq
    tq.MIN_SIZE = c["min_size"]
    tq.ROW_ACT_SCALES = c.get("row_act_scales", True)


def _match_codes(mine, records, mesh):
    """The JAX codes of the product whose codes are `mine` ([rows, K] on this
    rank): of every recorded [B, ..., K] array, the slices this rank could
    hold (its dp rows or all, its sp tokens or all, its tp channels or all),
    the one closest to `mine`."""
    best, fewest = None, None
    for rec in records:
        r = torch.from_numpy(rec.reshape(rec.shape[0], -1, rec.shape[-1]))
        for b in {1, mesh.shape["dp"]}:
            for s_ in {1, mesh.shape["sp"]}:
                for k in {1, mesh.shape["tp"]}:
                    if r.shape[0] % b or r.shape[1] % s_ or r.shape[2] % k:
                        continue
                    cand = r.chunk(b, 0)[mesh.coord["dp"] if b > 1 else 0]
                    cand = cand.chunk(s_, 1)[mesh.coord["sp"] if s_ > 1 else 0]
                    cand = cand.chunk(k, 2)[mesh.coord["tp"] if k > 1 else 0]
                    if cand.numel() != mine.numel() or cand.shape[-1] != mine.shape[-1]:
                        continue
                    cand = cand.reshape(mine.shape)
                    n = int((cand != mine).sum())
                    if fewest is None or n < fewest:
                        best, fewest = cand, n
    if best is None:
        raise AssertionError(f"no recorded product matches codes of shape {tuple(mine.shape)}")
    return best.contiguous()


def _quantized_tree(c, arr, params_key):
    """The case's fp32 tree (the JAX one's arrays) quantized as c says:
    bits, compute (W8A8 / W4A8, per-channel int4 scales), and calibrated
    scales fitted from an earlier calib case's statistics."""
    from versecrafter_tpu_torch.utils import quantize as tq
    bits, compute = c["bits"], c["compute"]
    scales = (tq.fit_act_scales([CALIB[c["scales_from"]]]) if c.get("scales_from")
              else None)
    tree = tq.quantize_tree(params_from_jax(unflatten(arr, params_key)), bits,
                            0 if bits == 4 and compute else None)
    return (tq.tag_int8_compute(tree, scales) if compute else tree), scales


def _same_tree(a, b):
    """Same structure, every tensor the same bits, and the same shard spec."""
    if isinstance(a, dict):
        return isinstance(b, dict) and sorted(a) == sorted(b) and all(
            _same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same_tree(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a, b)
                and getattr(a, shd.SPEC_ATTR, None) == getattr(b, shd.SPEC_ATTR, None))
    return a == b


def case_qdit(c, arr, mesh, out):
    """A quantized DiT forward under the mesh: the tree quantized whole,
    then sharded (c['orders']: also sharded fp32 first and quantized by the
    pipeline's quantize_weights, which must give the same shards). In the
    W8A8 / W4A8 modes each product takes the JAX package's activation codes
    (<name>.codes/<i>, recorded on its mesh) in place of its own; the codes
    that differed and their distance from a rounding boundary are kept."""
    from types import SimpleNamespace

    from versecrafter_tpu_torch.models import wan_dit as twan
    from versecrafter_tpu_torch.sampling import pipeline as tpipe
    from versecrafter_tpu_torch.utils import quantize as tq
    n, src = c["name"], c["params"]
    _quant_flags(c)
    cfg = _cfg(tconfig.WanDiTConfig, c["cfg"])
    tree, scales = _quantized_tree(c, arr, src + ".params")
    params = shd.shard_dit_params(tree, mesh)
    leaf = params["blocks"][0]
    for site, sub in (("ffn_in", leaf["ffn_in"]), ("ffn_out", leaf["ffn_out"]),
                      ("o", leaf["self_attn"]["o"])):
        k = sub["kernel"]
        k = k.get("qvalues", k.get("q4values")) if isinstance(k, dict) else k
        out[f"{n}.shape/{site}"] = np.asarray(tuple(k.shape))
    if c.get("orders"):
        pipe = SimpleNamespace(
            mesh=mesh, dit_params=shd.shard_dit_params(
                params_from_jax(unflatten(arr, src + ".params")), mesh),
            dit_params_high=None, _mesh_ctx=lambda: shd.mesh_context(mesh))
        tpipe.VerseCrafterPipeline.quantize_weights(
            pipe, int8_compute=c["compute"], act_scales=scales, bits=c["bits"])
        out[n + ".orders_equal"] = np.bool_(_same_tree(pipe.dit_params, params))
    records = [arr[k] for k in sorted((k for k in arr if k.startswith(n + ".codes/")),
                                      key=lambda k: int(k.rsplit("/", 1)[1]))]
    flips, dists, real = [], [], tq._quantize_rows

    def shared(x, a_global, group=None):
        a, mine = real(x, a_global, group)
        theirs = _match_codes(mine, records, mesh)
        r = x.float() / a
        differ = mine != theirs
        flips.append(int(differ.sum()))
        dists.extend(((r - r.floor() - 0.5).abs()[differ]).tolist())
        return a, theirs

    if records:
        tq._quantize_rows = shared
    try:
        with shd.mesh_context(mesh):
            y = twan.wan_dit_forward(params, cfg, *(_t(arr[f"{src}.{k}"]) for k in (
                "x", "t", "ctx", "cos", "sin")), geoada_context=_t(arr[src + ".g"]),
                geoada_scale=0.7)
    finally:
        tq._quantize_rows = real
    out[n + ".out"] = _np(y)
    out[n + ".products"] = np.int64(len(flips))
    out[n + ".flips"] = np.int64(sum(flips))
    out[n + ".flip_dist"] = np.float64(max(dists, default=0.0))


def case_calib(c, arr, mesh, out):
    """calibrate=True under the mesh: the output and the statistics (kept in
    CALIB for later cases)."""
    from versecrafter_tpu_torch.models import wan_dit as twan
    n, src = c["name"], c["params"]
    _quant_flags(c)
    cfg = _cfg(tconfig.WanDiTConfig, c["cfg"])
    params = shd.shard_dit_params(params_from_jax(unflatten(arr, src + ".params")), mesh)
    with shd.mesh_context(mesh):
        y, stats = twan.wan_dit_forward(params, cfg, *(_t(arr[f"{src}.{k}"]) for k in (
            "x", "t", "ctx", "cos", "sin")), geoada_context=_t(arr[src + ".g"]),
            geoada_scale=0.7, calibrate=True)
    CALIB[n] = stats
    out[n + ".out"] = _np(y)
    for grp, sites in stats.items():
        for site, v in sites.items():
            out[f"{n}.stats/{grp}/{site}"] = _np(v)


def case_record(c, arr, mesh, out):
    """record_teacache_stats through the sharded pipeline (the record state
    row-subsampled below c['subsample_rows'] rows): (rel_e0, rel_residual)
    and the recorded latents."""
    from versecrafter_tpu_torch.sampling import pipeline as tpipe
    from versecrafter_tpu_torch.sampling import teacache as ttc
    from versecrafter_tpu_torch.utils.tokenizer import HashTokenizer
    n, t = c["name"], c["trees"]
    ttc.TEA_RECORD_SUBSAMPLE_ROWS = c["subsample_rows"]
    cfgs = {k: _cfg(getattr(tconfig, cls), c[k]) for k, cls in (
        ("dit_cfg", "WanDiTConfig"), ("vae_cfg", "VAEConfig"), ("t5_cfg", "T5Config"))}
    pipe = tpipe.VerseCrafterPipeline(
        dit_params=params_from_jax(unflatten(arr, t + ".dit")),
        vae_params=params_from_jax(unflatten(arr, t + ".vae")),
        t5_params=params_from_jax(unflatten(arr, t + ".t5")),
        tokenizer=HashTokenizer(cfgs["t5_cfg"].vocab), device="cpu", mesh=mesh, **cfgs)
    rel_e0, rel_res = pipe.record_teacache_stats(
        "a car drives left", negative_prompt="static",
        control_videos=[arr[f"{n}.control{i}"] for i in range(2)],
        mask_video=arr[n + ".mask"], latents=arr[n + ".noise"], height=c["hw"][0],
        width=c["hw"][1], num_frames=c["frames"], num_inference_steps=c["steps"],
        guidance_scale=2.0, shift=c["shift"], dtype=torch.float32)
    out[n + ".rel_e0"] = np.asarray(rel_e0)
    out[n + ".rel_res"] = np.asarray(rel_res)
    out[n + ".latents"] = _np(pipe.last_record_latents)


CASES = {"dit": case_dit, "ring": case_ring, "ulysses": case_ulysses,
         "dispatch": case_dispatch, "t5": case_t5, "train": case_train,
         "pipeline": case_pipeline, "vae": case_vae, "init": case_init,
         "qdit": case_qdit, "calib": case_calib, "record": case_record}


def serve(job, arr):
    """A model server over this world: the tiny fp32 pipeline of the
    inputs, sharded over MeshSpec(*spec), each request's frames saved as
    .npy by rank 0."""
    from versecrafter_tpu_torch.sampling import pipeline as tpipe
    from versecrafter_tpu_torch.serve import model_server as tserve
    from versecrafter_tpu_torch.utils.tokenizer import HashTokenizer
    c = job["serve"]
    if "min_size" in c:
        from versecrafter_tpu_torch.utils import quantize as tq
        tq.MIN_SIZE = c["min_size"]
    cfgs = {k: _cfg(getattr(tconfig, cls), c[k]) for k, cls in (
        ("dit_cfg", "WanDiTConfig"), ("vae_cfg", "VAEConfig"), ("t5_cfg", "T5Config"))}

    class FP32(tpipe.VerseCrafterPipeline):
        def __call__(self, *a, **kw):
            return super().__call__(*a, dtype=torch.float32, **kw)

    def factory():
        pipe = FP32(dit_params=params_from_jax(unflatten(arr, "dit")),
                    vae_params=params_from_jax(unflatten(arr, "vae")),
                    t5_params=params_from_jax(unflatten(arr, "t5")),
                    tokenizer=HashTokenizer(cfgs["t5_cfg"].vocab), device="cpu", **cfgs)
        pipe.set_mesh(tserve.resolve_mesh(MeshSpec(*job["spec"]), device="cpu"))
        return pipe

    if c.get("fail_first_unload_on") == torch.distributed.get_rank():
        real_free, calls = tserve._free_device, []

        def free_device():  # this rank's first unload fails
            calls.append(1)
            if len(calls) == 1:
                raise RuntimeError("unload failed on this rank")
            real_free()
        tserve._free_device = free_device

    class Saving(tserve.ModelServer):
        def _save(self, video, params):
            path = os.path.join(job["out_dir"], f"frames{len(os.listdir(job['out_dir']))}.npy")
            np.save(path, video)
            return path

    Saving(factory).serve("127.0.0.1", c["port"])


def cli(job):
    """The generate CLI with job['cli']'s flags on this world, MIN_SIZE
    lowered to job['min_size']; rank 0's frames saved as frames.npy."""
    from versecrafter_tpu_torch.cli import inference as tinf
    from versecrafter_tpu_torch.serve import model_server as tserve
    from versecrafter_tpu_torch.utils import quantize as tq
    tq.MIN_SIZE = job["min_size"]

    def save(video, params, default_dir=None):
        path = os.path.join(job["out_dir"], "frames.npy")
        np.save(path, video)
        return path
    tserve.save_generated_video = save
    tinf.main(job["cli"])
    np.savez(os.path.join(job["out_dir"], f"rank{torch.distributed.get_rank()}.npz"))


def main():
    with open(sys.argv[1]) as f:
        job = json.load(f)
    torch.set_num_threads(1)
    assert maybe_init_distributed("cpu")
    if "timeout_s" in job:  # the default group's limit, lowered after the rendezvous
        torch.distributed.distributed_c10d._set_pg_timeout(
            datetime.timedelta(seconds=job["timeout_s"]))
    if "serve" in job:
        return serve(job, dict(np.load(job["inputs"])))
    if "cli" in job:
        return cli(job)
    mesh = make_mesh(MeshSpec(*job["spec"]), device="cpu")
    arr = dict(np.load(job["inputs"]))
    out = {}
    for c in job["cases"]:
        CASES[c["kind"]](c, arr, mesh, out)
    np.savez(os.path.join(job["out_dir"], f"rank{mesh.rank}.npz"), **out)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
