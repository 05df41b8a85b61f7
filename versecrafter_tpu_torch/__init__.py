"""PyTorch/CUDA port of versecrafter_tpu for one NVIDIA H100.

The JAX package beside it is the reference this port is tested against; this
package imports torch and numpy only, and nothing of the JAX package. Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

import os

# The CUDA caching allocator with expandable segments. A DiT quantized
# block by block as it is built or loaded (utils/quantize.quantize_dit)
# leaves its int8 leaves in segments split by the bf16 blocks and the
# temporaries it freed; with a resident Wan2.2-A14B W8A8 pair on one 80 GB
# card the 480x832x81 request then ran out of memory at 64.0 GiB allocated
# beside 11.4 GiB reserved but unused (PERF.md). Read at the first CUDA
# allocation, so it holds when the port is imported before one; a setting
# of the caller's stands.
if "PYTORCH_ALLOC_CONF" not in os.environ:
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import torch  # noqa: E402


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, the CPU only
    when the caller asks for it. Raises when CUDA is wanted but missing —
    never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
