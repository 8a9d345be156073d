"""A run that finds no card names the missing card, exits 2 and prints no
result; it never falls back to the CPU."""

import os
import subprocess
import sys

from portbench import bench


def test_no_card_exits_without_a_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "softdof.final256", "--seed", str(2**40 + 3), "--seconds", "1",
         "--trace", "0"], cwd=str(bench.ROOT), env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr and "1 NVIDIA" in out.stderr


def test_require_cards_raises():
    import torch

    if torch.cuda.is_available():
        return
    try:
        bench.require_cards(4)
    except bench.NoCard as e:
        assert "4" in str(e)
    else:
        raise AssertionError("no NoCard without a card")
