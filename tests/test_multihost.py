"""Multi-process (2 and 4) multi-host SPMD integration: the sharded decode
step runs across processes (gloo collectives over the coordination
service) and its psum-merged counters equal the single-process result."""

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "multihost_worker.py")


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


import pytest


@pytest.mark.parametrize("num_processes", [2, 4])
def test_multi_process_decode_and_psum(num_processes):
    coordinator = f"127.0.0.1:{free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    workers = [
        subprocess.Popen(
            [sys.executable, WORKER, str(rank), coordinator, str(num_processes)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
        )
        for rank in range(num_processes)
    ]
    outputs = []
    for rank, worker in enumerate(workers):
        out, err = worker.communicate(timeout=300)
        outputs.append((rank, worker.returncode, out, err))
    for rank, code, out, err in outputs:
        assert code == 0, (rank, err[-3000:])
        assert f"MULTIHOST-OK {rank}" in out, (rank, out, err[-1500:])
