"""Hand-written CUDA kernels for sm_90a (sources in `csrc/`, built and bound
by `build.py`).

`launches` counts, per kernel, the launches its wrapper made (one per
wrapper call that reached the kernel). `launches_by_rows` splits the flash
kernels' counts by the query-row count of each launch: {(name, rows): n}.
The wrappers live beside their plain PyTorch versions in `ops/attention.py`,
`ops/norms.py` and `ops/bias_act.py`.
"""

KERNELS = (
    "flash_attention_d32",
    "flash_attention_d512",
    "flash_attention_packed",
    "group_norm",
    "group_norm_two_pass",
    "bias_act",
)

launches = dict.fromkeys(KERNELS, 0)
launches_by_rows = {}


def count_launch(name: str, rows: int) -> None:
    """One launch of kernel `name` over `rows` query rows."""
    launches[name] += 1
    launches_by_rows[(name, rows)] = launches_by_rows.get((name, rows), 0) + 1


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0
    launches_by_rows.clear()
