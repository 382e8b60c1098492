"""Hand-written CUDA kernels for sm_90a (sources in `csrc/`, built and bound
by `build.py`).

`launches` counts, per kernel, the launches its wrapper made (one per
wrapper call that reached the kernel); flash attention counts per head dim
and entry point (`ops.attention.flash_counter`), under names that appear at
their first launch. `launch_details` splits those counts
by what each launch was given: {(name, detail): n}, the detail being the
query-row count for flash attention and (layout, shape, dtype) for
GroupNorm. The wrappers live beside their plain PyTorch versions in
`ops/attention.py`, `ops/norms.py` and `ops/bias_act.py`.
"""

import collections

KERNELS = ("group_norm", "group_norm_two_pass", "bias_act")

launches = collections.Counter(dict.fromkeys(KERNELS, 0))
launch_details = {}


def count_launch(name: str, detail) -> None:
    """One launch of kernel `name`, given inputs described by `detail`."""
    launches[name] += 1
    launch_details[(name, detail)] = launch_details.get((name, detail), 0) + 1


def reset_launch_counts() -> None:
    launches.clear()
    launches.update(dict.fromkeys(KERNELS, 0))
    launch_details.clear()
