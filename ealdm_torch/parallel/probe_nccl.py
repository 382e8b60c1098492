"""Two NCCL ranks on one card, to see what NCCL says (the backend rule of
`serving.maybe_initialize_distributed` rests on it):

    python -m ealdm_torch.parallel.probe_nccl

Each rank sets `cuda:0`, starts an NCCL group of two and all-reduces four
ones; it prints the sum or the error it met. Needs one card.
"""
from __future__ import annotations

import datetime
import os
import socket

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank(r: int, port: int) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.cuda.set_device(0)
    try:
        dist.init_process_group("nccl", rank=r, world_size=2,
                                timeout=datetime.timedelta(seconds=60))
        t = torch.ones(4, device="cuda:0")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        print(f"rank {r}: all_reduce gave {t.tolist()}", flush=True)
    except Exception as e:  # the finding is the error itself
        print(f"rank {r}: {type(e).__name__}: {e}"[:1500], flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("probe_nccl needs a card")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    print(torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0), flush=True)
    mp.start_processes(_rank, args=(port,), nprocs=2, start_method="spawn", join=True)


if __name__ == "__main__":
    main()
