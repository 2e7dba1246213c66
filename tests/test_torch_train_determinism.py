"""``scripts/torch_train_determinism.py`` on the CPU, at its ``--small`` size.

The script's card run is what shows whether training repeats itself there;
here its runs, its comparison and its three-way step timing run end to end
on the CPU (where every run repeats), and its comparison is shown to name
what differs.
"""

from __future__ import annotations

import json

import pytest
import torch

from torch_test_support import load


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def det():
    return load("scripts/torch_train_determinism.py")


def _run(det, tmp_path, capsys, *argv) -> tuple[dict, dict]:
    out = tmp_path / "out.json"
    assert det.main([*argv, "--device", "cpu", "--small", "--out", str(out)]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return last, json.loads(out.read_text())


@pytest.mark.parametrize("former", [False, True])
def test_every_trainer_repeats_itself_on_cpu(det, tmp_path, capsys, former):
    """The towers and the simulators' trainers in this process, the MMT in a
    gloo rank (plain and with a mesh), each under the default algorithms and
    the switch: every run equals the first, with the lookups through E1 and
    as they were before it."""
    flags = ["--former-lookups"] if former else []
    last, doc = _run(det, tmp_path, capsys, "--trainer", "shift", "ir", "clip", "blip", "mmt",
                     "--reps", "2", "--det-reps", "1", *flags)
    assert last["card"] == "cpu" and last["former_lookups"] == former
    for trainer in ("shift", "ir", "clip", "blip", "mmt"):
        runs = 2 if trainer == "mmt" else 1  # the MMT's plain and mesh runs
        assert last[trainer]["default"] == dict(last[trainer]["default"], runs=2 * runs, differ=0)
        assert last[trainer]["deterministic"]["runs"] == runs
        assert last[trainer]["deterministic"]["differ"] == 0
        rows = doc["runs"][trainer]
        assert all(r["losses_equal"] and not r["tensors_differ"] for r in rows)


def test_compare_names_the_step_and_tensors_that_differ(det):
    sig = lambda *v: (["a.weight", "b.bias"], torch.tensor(v))
    ref = det.Run([1.0, 0.5], {"a.weight": torch.zeros(2), "b.bias": torch.ones(1)},
                  [sig(1, 2), sig(3, 4)], 0.1)
    same = det.compare(ref._replace(secs=0.2), ref)
    assert same == dict(losses_equal=True, tensors_differ={}, first_gradient_difference=None)
    other = ref._replace(losses=[1.0, 0.25], trace=[sig(1, 2), sig(3, 5)],
                         params={"a.weight": torch.tensor([0.0, 1e-8]), "b.bias": torch.ones(1)})
    got = det.compare(other, ref)
    assert got["losses_equal"] is False
    assert got["first_gradient_difference"] == (1, ["b.bias"])
    assert list(got["tensors_differ"]) == ["a.weight"]
    assert det.differs(dict(got)) and not det.differs(dict(same))


def test_step_times_three_ways_on_cpu(det, tmp_path, capsys):
    """The MMT, CLIP and BLIP steps timed three ways in turn; on the CPU no
    kernel launches, and the lookups are back as they were after each way."""
    from multimodalspectraltransformer_torch.models import mmt
    from multimodalspectraltransformer_torch.ops import embedding_grad as e1

    last, doc = _run(det, tmp_path, capsys, "--step-times")
    for trainer in ("mmt", "clip", "blip"):
        row = last[trainer]
        assert row["batch"] == 8 and row["e1_launches_a_step"] == 0
        assert all(row[f"{w}_ms"] > 0 for w in det.WAYS)
        assert all(len(doc["step_times"][trainer]["ms"][w]) == 3 for w in det.WAYS)
    assert mmt.embedding_lookup is e1.embedding_lookup
    assert not torch.are_deterministic_algorithms_enabled()
