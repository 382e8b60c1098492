"""Hand-written CUDA kernels for sm_90a (sources in `csrc/`, built and bound
by `build.py`).

`launches` counts, per kernel, the launches its wrapper made (one per
wrapper call that reached the kernel). The wrappers live beside their plain
PyTorch versions in `ops/attention.py`, `ops/norms.py` and `ops/bias_act.py`.
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


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0
