"""A world-1 gloo process group in the test's own process, for the CPU
checks that a mesh of one rank gives the single-device result."""
import contextlib

import torch.distributed as dist


@contextlib.contextmanager
def world1_gloo():
    """Start a one-rank gloo group (unless one is up) and yield the port's
    world-1 CPU data mesh; the group this started is destroyed on exit,
    so later tests in the worker see no group."""
    from mmlspark_tpu_torch.parallel.mesh import make_mesh

    started = not dist.is_initialized()
    try:
        yield make_mesh(device="cpu")
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
