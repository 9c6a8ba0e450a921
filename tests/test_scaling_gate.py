"""The multichip scaling gate must FAIL on a real scaling regression.

A gate that passes at partition_efficiency 0.9
(sharded slower than single-device) cannot catch anything. The dryrun now
asserts >=1.0; this test proves the gate trips by deliberately breaking
work partitioning (every device processes the FULL batch instead of its
1/N shard — the replication failure mode named in SURVEY §2.9 DP).
"""

import os

import pytest

from pheniqs_tpu.tools.multichip_bench import run_scaling


@pytest.mark.skipif(os.cpu_count() < 2, reason="needs >=2 cores")
def test_replicated_batch_trips_the_gate(monkeypatch):
    # PHENIQS_SCALING_BREAK=1 makes run_device_step tile the batch
    # n_devices-fold (each device's shard = the full workload); total
    # compute rises ~N-fold on the same host cores, so the sharded step
    # must come out decisively slower than single-device.
    monkeypatch.setenv("PHENIQS_SCALING_BREAK", "1")
    broken = run_scaling(4, reads=8192)
    assert broken["partition_efficiency"] < 1.0, broken
    # the dryrun gate (__graft_entry__.py) asserts >= 1.0, so this
    # regression would fail the driver's multichip validation
