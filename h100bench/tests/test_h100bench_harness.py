"""The harness around the port: the window on the host, the command without
a card, and one short cell on the card."""

import json
import os
import subprocess
import sys

import pytest

from h100bench.tests import _tiny

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def test_deadline_stops_admission_and_in_flight_holes_drain(tmp_path):
    # a zero-second window admits the first hole only; it drains, is
    # written and checked
    r = _tiny.run(tmp_path, seconds=0.0)
    assert r["attempted"] == 1 and r["failed"] == 0
    assert r["correct"] is True
    assert list(r["checks"]) == ["mismatched_records", "order_faults"]
    assert r["device"]["platform"] == "cpu"
    assert set(r["metrics"]) == {"subread_bases_per_s", "setup_s"}


def test_a_longer_window_laps_the_corpus(tmp_path):
    r = _tiny.run(tmp_path, seconds=6.0)
    assert r["attempted"] > _tiny.MIX["pool_holes"]
    assert r["failed"] == 0 and r["correct"] is True
    names = [n for n, _ in __import__(
        "h100bench.harness.window", fromlist=["read_fasta"]).read_fasta(
            str(tmp_path / "out" / "tiny" / "window.fa"))]
    assert len(names) == len(set(names)) == r["attempted"]


def test_the_command_fails_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run")
    p = subprocess.run(
        [sys.executable, "h100bench/run.py", "--workload", "hifi_wgs.ins15k",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())


@pytest.mark.cuda
def test_one_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    p = subprocess.run(
        [sys.executable, "h100bench/run.py", "--workload",
         "amplicon_16s.fl16s", "--seed", "2147483659", "--seconds", "3",
         "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.splitlines()[-1])
    assert r["correct"] is True and r["attempted"] > 0
    assert r["device"]["platform"] == "gpu"
    assert r["metrics"]["subread_bases_per_s"]["value"] > 0
