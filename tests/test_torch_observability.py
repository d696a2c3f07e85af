"""The port's observability (pafuse_tpu_torch.utils.observability) and its
use in the H3WB CLI: twins of tests/test_observability.py's
``test_summary_writer``, ``test_profile_flag_writes_trace`` and
``test_measure_throughput``, and the CLI's TensorBoard event file with the
JAX CLI's tags (``pafuse_tpu/cli/main_h3wb.py:128-129, 334-339``)."""

import os
import struct

import pytest
import torch

from pafuse_tpu_torch.cli import main_h3wb
from pafuse_tpu_torch.utils import observability as obs

torch.set_num_threads(2)

TINY = ["gpu.device=cpu", "data.synthetic=true", "data.synthetic_actions=1",
        "data.synthetic_frames=40", "model.number_of_frames=9",
        "model.batch_size=18", "model.dep=1", "ft2d.timestep=20",
        "ft2d.sampling_timesteps=1", "ft2d.num_proposals=1",
        "ft2d.debug=true", "model.epochs=1"]

#: the scalars the JAX CLI writes each epoch, letter for letter (the
#: misspelt "learing" included); tensorboardX stores them with spaces as
#: underscores, for either package
JAX_SCALARS = {"Loss/3d training loss", "Loss/3d validation loss",
               "Parameters/learing rate", "Parameters/training time per epoch"}


def _event_tags(logdir):
    """The summary tags of every event file in ``logdir`` (TFRecord frames:
    length, its CRC, an ``Event`` protobuf, its CRC)."""
    from tensorboardX.proto import event_pb2
    tags = set()
    for name in os.listdir(logdir):
        if not name.startswith("events.out.tfevents"):
            continue
        with open(os.path.join(logdir, name), "rb") as f:
            data = f.read()
        i = 0
        while i < len(data):
            n = struct.unpack("<Q", data[i:i + 8])[0]
            event = event_pb2.Event.FromString(data[i + 12:i + 12 + n])
            tags |= {v.tag for v in event.summary.value}
            i += 12 + n + 4
    return tags


def test_summary_writer(tmp_path):
    w = obs.make_summary_writer(str(tmp_path))
    assert w is not None        # tensorboardX is installed here
    w.add_scalar("loss", 1.0, 1)
    w.add_text("note", "hello")
    w.close()
    assert any(tmp_path.iterdir())
    assert "loss" in _event_tags(str(tmp_path))


def test_measure_throughput():
    def f(x):
        return x * 2.0

    stats = obs.measure_throughput(f, torch.ones(8, 8), iters=3,
                                   items_per_call=8)
    assert stats["seconds_per_call"] > 0
    assert stats["items_per_second"] > 0


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with obs.profile_trace(str(tmp_path / "p"), "cpu"):
        torch.ones(16, 16) @ torch.ones(16, 16)
    assert (tmp_path / "p" / "trace.json").stat().st_size > 0


def test_cli_writes_the_jax_tags(tmp_path, monkeypatch):
    """A training run without general.nolog writes one event file in its
    log directory with the JAX CLI's description, command and per-epoch
    scalars."""
    monkeypatch.chdir(tmp_path)
    main_h3wb.main(TINY + [f"general.log={tmp_path}/log",
                           f"general.checkpoint={tmp_path}/ck"])
    logs = [d for d in os.listdir(tmp_path) if d.startswith("log_")]
    assert len(logs) == 1
    tags = _event_tags(str(tmp_path / logs[0]))
    assert {t.replace(" ", "_") for t in JAX_SCALARS} <= tags
    assert {"description/text_summary", "command/text_summary"} <= tags


def test_nolog_writes_no_event_file(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    main_h3wb.main(TINY + ["general.nolog=true", f"general.log={tmp_path}/log",
                           f"general.checkpoint={tmp_path}/ck"])
    found = [f for _, _, files in os.walk(tmp_path) for f in files
             if f.startswith("events.out.tfevents")]
    assert found == []


@pytest.mark.parametrize("profile", [True, False])
def test_profile_flag_writes_trace(tmp_path, monkeypatch, profile):
    """gpu.profile=true traces the first trained epoch into
    <checkpoint>/profile; without it nothing is traced."""
    monkeypatch.chdir(tmp_path)
    main_h3wb.main(TINY + ["general.nolog=true", "experiment.no_eval=true",
                           f"gpu.profile={str(profile).lower()}",
                           f"general.checkpoint={tmp_path}/ck"])
    prof_dir = tmp_path / "ck" / "profile"
    assert prof_dir.exists() == profile
    if profile:
        assert (prof_dir / "trace.json").stat().st_size > 0
