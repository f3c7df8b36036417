"""The port's telemetry spine (`apex1_tpu_torch.obs.spine`) on the JAX
package's schema: `StopWatch`, `ObsRun` and its span durations, the
default run re-keyed when ``APEX1_OBS_DIR`` changes, a torn last line
skipped, and each package's `read_events` reading the other's file."""

import json
import os
import time

import pytest
import torch

from apex1_tpu.obs import spine as jspine
from apex1_tpu_torch.obs import (ObsRun, StopWatch, default_run, emit,
                                 read_events, set_default_run, spine)
from apex1_tpu_torch.utils.observability import MetricsLogger


def test_stopwatch_accumulates_and_syncs_cpu_trees():
    sw = StopWatch()
    sw.start()
    time.sleep(0.01)
    first = sw.stop(sync={"a": torch.ones(2), "b": [torch.zeros(1), 3]})
    assert first >= 0.01 and sw.last_s == first and sw.count == 1
    sw.start()
    second = sw.stop()
    assert sw.count == 2
    assert sw.elapsed() == pytest.approx(first + second)
    assert sw.elapsed(reset=True) == pytest.approx(first + second)
    assert sw.elapsed() == 0.0 and sw.count == 0


def test_obs_run_writes_the_schema_and_span_durations(tmp_path):
    with ObsRun(dir=str(tmp_path), component="unit", meta={"k": 1}) as run:
        with run.span("work", sync=torch.ones(3), phase="a") as sw:
            time.sleep(0.02)
        run.counter("steps", 3)
        run.gauge("loss", 1.5, unit="nats")
        run.event("done", ok=True)
        with pytest.raises(ValueError, match="unknown event kind"):
            run.emit("bogus", "x")
    run.event("after close")   # dropped, not raised
    recs = read_events(run.path)
    head = recs[0]
    assert head["schema"] == spine.SCHEMA == jspine.SCHEMA
    assert (head["kind"], head["component"], head["meta"]) == (
        "run", "unit", {"k": 1})
    assert head["pid"] == os.getpid()
    assert [(r["kind"], r["name"]) for r in recs[1:]] == [
        ("span", "work"), ("counter", "steps"), ("gauge", "loss"),
        ("event", "done")]
    span = recs[1]
    assert span["dur_s"] >= 0.02 and span["phase"] == "a"
    assert span["dur_s"] == pytest.approx(sw.last_s, abs=1e-6)
    assert recs[2]["value"] == 3 and recs[3]["unit"] == "nats"
    assert read_events(run.path, kinds=("gauge",)) == [recs[3]]
    with pytest.raises(ValueError, match="APEX1_OBS_DIR"):
        ObsRun()


def test_default_run_is_keyed_on_the_dir(tmp_path, monkeypatch):
    monkeypatch.delenv("APEX1_OBS_DIR", raising=False)
    set_default_run(None)
    assert default_run() is None
    emit("event", "nowhere")   # inert: no file
    monkeypatch.setenv("APEX1_OBS_DIR", str(tmp_path / "a"))
    a = default_run()
    assert a is default_run()
    emit("event", "into a", n=1)
    monkeypatch.setenv("APEX1_OBS_DIR", str(tmp_path / "b"))
    b = default_run()
    assert b is not a and a._f.closed
    emit("event", "into b")
    monkeypatch.delenv("APEX1_OBS_DIR")
    assert default_run() is None and b._f.closed
    assert [r.get("name") for r in read_events(a.path)] == [None, "into a"]
    assert [r.get("name") for r in read_events(b.path)] == [None, "into b"]
    own = ObsRun(dir=str(tmp_path / "c"))
    set_default_run(own)
    emit("counter", "c", value=2)
    set_default_run(None)
    own.close()
    assert read_events(own.path)[-1]["value"] == 2


def test_a_torn_last_line_is_skipped(tmp_path):
    run = ObsRun(dir=str(tmp_path))
    run.event("kept", i=1)
    run.close()
    with open(run.path, "a") as f:
        f.write('{"kind": "event", "name": "tor')
    recs = read_events(run.path)
    assert [r.get("name") for r in recs] == [None, "kept"]


def test_each_package_reads_the_others_file(tmp_path):
    port = ObsRun(dir=str(tmp_path / "port"), component="port")
    with port.span("s"):
        pass
    port.counter("c", 7)
    port.close()
    jax_run = jspine.ObsRun(dir=str(tmp_path / "jax"), component="jax")
    with jax_run.span("s"):
        pass
    jax_run.gauge("g", 0.5)
    jax_run.close()
    for path in (port.path, jax_run.path):
        assert read_events(path) == jspine.read_events(path)
    assert [r["kind"] for r in read_events(jax_run.path)] == [
        "run", "span", "gauge"]
    assert [r["kind"] for r in jspine.read_events(port.path)] == [
        "run", "span", "counter"]


def test_metrics_logger_mirrors_into_the_spine(tmp_path, monkeypatch):
    monkeypatch.setenv("APEX1_OBS_DIR", str(tmp_path))
    lines = []
    log = MetricsLogger(writer=lines.append)
    log.log(0, {"loss": torch.tensor(2.5), "tag": "x"}, tokens=8)
    run = default_run()
    monkeypatch.delenv("APEX1_OBS_DIR")
    default_run()
    rec = read_events(run.path, kinds=("event",))[0]
    assert rec["name"] == "metrics" and rec["loss"] == 2.5
    assert json.loads(lines[0]) == {"step": 0, "loss": 2.5, "tag": "x"}
