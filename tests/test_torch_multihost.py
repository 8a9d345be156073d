"""Two processes of the port's CLI under torch.distributed (gloo, on the
CPU): the counterpart of tests/test_multihost.py.

Each rank runs `python -m qaray_tpu_torch.cli ... -device cpu -multihost
-coordinator localhost:P,2,r -rank-debug` on spot_scene at 64x48 with 2
samples a pixel: parallel/distributed.init_distributed, the sharded
dispatches with their cross-process all_gather (parallel/mesh.py), the
rank-debug planes and the primary-only writes. The primary's PNG must
equal a single-process render bit for bit (a lane's draws do not depend on
the batch layout). Each child caps its torch threads (-threads) to its
share of the worker's cores, as tests/test_torch_workers.py caps the
workers, and has its own timeout.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from test_torch_workers import worker_threads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "tests", "assets", "spot_scene.xml")
ARGS = [SCENE, "-device", "cpu", "-res", "64x48", "-spp", "2", "-sppMin",
        "2", "-bounce", "2"]


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _cli(args, threads):
    return [sys.executable, "-m", "qaray_tpu_torch.cli", *ARGS, *args,
            "-threads", str(threads)]


@pytest.mark.parametrize("init", ["coordinator", "env"])
def test_two_process_multihost_matches_single(tmp_path, init):
    """-coordinator A,N,P, or (env) no -coordinator and the group read from
    MASTER_ADDR, MASTER_PORT, RANK and WORLD_SIZE."""
    threads = max(1, (worker_threads() or len(os.sched_getaffinity(0)))
                  // 2)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
              "LOCAL_RANK"):
        env.pop(k, None)

    def rank_args(rank):
        if init == "coordinator":
            return ["-coordinator", f"localhost:{port},2,{rank}"], env
        return [], dict(env, MASTER_ADDR="localhost", MASTER_PORT=str(port),
                        RANK=str(rank), WORLD_SIZE="2")

    procs = []
    for rank in range(2):
        args, rank_env = rank_args(rank)
        procs.append(subprocess.Popen(
            _cli(["-multihost", *args, "-rank-debug", "-out",
                  str(tmp_path / f"mh{rank}_")], threads),
            env=rank_env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=tmp_path))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-3000:]}"
        assert f"multihost: process {rank}/2, 2 devices" in out
        assert "Elapsed Time is" in out
        assert f"multihost: process {rank}, " in out and "(gloo)" in out
    # Primary-only writes: rank 1 writes its rank-debug planes alone.
    assert (tmp_path / "mh0_colorBuffer.png").exists()
    assert not (tmp_path / "mh1_colorBuffer.png").exists()
    assert not (tmp_path / "mh1_depthBuffer.png").exists()
    m0 = np.asarray(Image.open(tmp_path / "mh0_rank0_maskBuffer.png"))
    m1 = np.asarray(Image.open(tmp_path / "mh1_rank1_maskBuffer.png"))
    assert (tmp_path / "mh0_rank0_sampleBuffer.png").exists()
    assert (tmp_path / "mh1_rank1_sampleBuffer.png").exists()
    # Owned-sample counts: across the ranks they sum to the spp.
    assert np.all(m0.astype(int) + m1.astype(int) == 2), "counts != spp"
    assert m0.sum() > 0 and m1.sum() > 0

    single = subprocess.run(_cli(["-out", str(tmp_path / "sp_")], threads),
                            env=env, cwd=tmp_path, capture_output=True,
                            text=True, timeout=240)
    assert single.returncode == 0, single.stdout + single.stderr
    multi = np.asarray(Image.open(tmp_path / "mh0_colorBuffer.png"))
    solo = np.asarray(Image.open(tmp_path / "sp_colorBuffer.png"))
    assert multi.shape == solo.shape == (48, 64, 3)
    assert np.array_equal(multi, solo), (
        np.abs(multi.astype(int) - solo.astype(int)).max())
