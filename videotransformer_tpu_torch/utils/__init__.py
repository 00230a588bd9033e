"""Host helpers of the port (reference utils.py): the rank helpers, timing,
parameter groups and image helpers (``helpers``), and profiling
(``profiling``)."""

from videotransformer_tpu_torch.utils.helpers import (
    build_param_groups,
    denormalize,
    get_rank,
    get_world_size,
    is_dist_avail_and_initialized,
    is_main_process,
    print_on_rank_zero,
    show_processed_image,
    timeit_wrapper,
)

__all__ = [
    "build_param_groups",
    "denormalize", "get_rank", "get_world_size",
    "is_dist_avail_and_initialized", "is_main_process", "print_on_rank_zero",
    "show_processed_image", "timeit_wrapper",
]
