from versecrafter_tpu_torch.parallel.sharding import (  # noqa: F401
    constrain_tokens,
    current_mesh,
    mesh_context,
    shard_dit_params,
    sp_cross_attention,
    ulysses_attention,
)
