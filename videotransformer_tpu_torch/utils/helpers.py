"""The original repo's rank helpers (utils.py:16-34) on torch.distributed.

Port of the distributed half of ``videotransformer_tpu/utils/helpers.py``
(:17-36), which asks JAX's process set; here the world is the initialised
``torch.distributed`` process group, and a run without one is rank 0 of 1.
"""

import torch.distributed as dist


def is_dist_avail_and_initialized():
    return dist.is_available() and dist.is_initialized()


def get_world_size():
    return dist.get_world_size() if is_dist_avail_and_initialized() else 1


def get_rank():
    return dist.get_rank() if is_dist_avail_and_initialized() else 0


def is_main_process():
    return get_rank() == 0


def print_on_rank_zero(*args, **kwargs):
    if is_main_process():
        print(*args, **kwargs, flush=True)
