"""One rank of a gloo world that runs the port's parallel paths (see
tests/torch_mesh.py). Imports torch and the port only.

    python tests/torch_mesh_worker.py job.json     (under torchrun's env)

The job names a MeshSpec and a list of cases; the inputs are one .npz of
flattened trees. Each rank writes its outputs to <out_dir>/rank<r>.npz.
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
    twan._ffn = lambda p, x: ffn_rows.append(x.shape[:-1].numel()) or real_ffn(p, x)
    twan.FFN_CHUNK_ROWS = c.get("ffn_chunk_rows", real_chunk)
    try:
        with shd.mesh_context(mesh):
            y = twan.wan_dit_forward(params, cfg, _t(arr[n + ".x"]), _t(arr[n + ".t"]),
                                     _t(arr[n + ".ctx"]), _t(arr[n + ".cos"]),
                                     _t(arr[n + ".sin"]), geoada_context=g, **extras)
    finally:
        twan._ffn, twan.FFN_CHUNK_ROWS = real_ffn, real_chunk
    out[n + ".out"] = _np(y)
    out[n + ".ffn_rows"] = np.int64(max(ffn_rows))
    out[n + ".ulysses"] = np.int64(COUNTS.get("ulysses_attention", 0))
    out[n + ".ring"] = np.int64(COUNTS.get("ring_sp_attention", 0))


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


CASES = {"dit": case_dit, "ring": case_ring, "ulysses": case_ulysses,
         "dispatch": case_dispatch, "t5": case_t5, "train": case_train,
         "pipeline": case_pipeline, "vae": case_vae, "init": case_init}


def serve(job, arr):
    """A model server over this world: the tiny fp32 pipeline of the
    inputs, sharded over MeshSpec(*spec), each request's frames saved as
    .npy by rank 0."""
    from versecrafter_tpu_torch.sampling import pipeline as tpipe
    from versecrafter_tpu_torch.serve import model_server as tserve
    from versecrafter_tpu_torch.utils.tokenizer import HashTokenizer
    c = job["serve"]
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
