"""Worker process entry point: `python -m ray_tpu_torch.core.worker_main <fd>`.

Port of `ray_tpu/core/worker_main.py`. Workers are launched as a
dedicated program instead of a multiprocessing spawn of the caller's
`__main__`, so a worker never re-imports or re-executes the caller's
script, and never inherits a forked CUDA context. The single argument is
an inherited socketpair fd; frames on it are the protocol of
`worker_pool._worker_main`.
"""

from __future__ import annotations

import sys
from multiprocessing.connection import Connection


def main() -> None:
    fd = int(sys.argv[1])
    conn = Connection(fd)
    from ray_tpu_torch.core.worker_pool import _worker_main

    _worker_main(conn, {})


if __name__ == "__main__":
    main()
