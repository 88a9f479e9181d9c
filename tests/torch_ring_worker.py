"""One rank of the port's ``ProcessGroupRing`` under gloo, started by
``tests/test_torch_ring_attention.py`` in a forked process: joins the group
through ``core.distributed.initialize`` (file-store rendezvous), runs ring
attention forward and backward on the replicated inputs, and saves what the
rank holds. Imports torch and the port only."""

import os

import torch
import torch.distributed as dist


def run(rank: int, world: int, store: str, inputs: str, out: str) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    from depth_completion_tpu_torch.core.distributed import initialize, is_primary
    from depth_completion_tpu_torch.ops.ring_attention import ProcessGroupRing, ring_attention

    initialize(device="cpu", init_method=f"file://{store}")
    try:
        q, k, v, do, heads = torch.load(inputs)
        q, k, v = (x.clone().requires_grad_(True) for x in (q, k, v))
        o = ring_attention(q, k, v, heads, ProcessGroupRing())
        grads = torch.autograd.grad(o, (q, k, v), do)
        torch.save({"o": o.detach(), "grads": grads, "primary": is_primary()}, out)
    finally:
        dist.destroy_process_group()
