"""The port's directory server against the JAX package's.

A tiny ResNet-18 pipeline (loc 64^2, crop 32, padded 128, f32) with the same
seeded Flax variables in both packages serves the same requests; then the
port's claim recovery for every owner layout, the claim race that the JAX
package's ``<host>-<pid>`` naming loses, two servers on one watch directory
and the clean shutdown.
"""

import json
import os
import socket
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spine_vision_torch import io as tio
from spine_vision_torch.infer import pipeline as tpipe
from spine_vision_torch.infer import serve as tserve
from spine_vision_torch.models import classifier as tcls
from spine_vision_torch.models.convert import load_flax_variables, random_flax_variables
from spine_vision_tpu.infer import StudyInferencePipeline, StudyPipelineConfig
from spine_vision_tpu.infer.serve import serve_directory as jax_serve_directory
from spine_vision_tpu.models import Classifier, CoordinateRegressor

_CONFIG = {"loc_image_size": (64, 64), "crop_size": (32, 32), "padded_hw": (128, 128)}
_BAD = {"t1": "/nonexistent"}  # no 't2': rejected before any decode


@pytest.fixture(scope="module")
def pipelines():
    loc = tcls.CoordinateRegressor("resnet18", dtype=torch.float32, device="cpu")
    cls = tcls.Classifier("resnet18", dtype=torch.float32, device="cpu")
    trees = []
    for model, seed in ((loc, 0), (cls, 1)):
        params, stats = random_flax_variables(model, seed)
        load_flax_variables(model, params, stats)
        trees.append({"params": params, **({"batch_stats": stats} if stats else {})})
    port = tpipe.StudyInferencePipeline(
        loc, cls, config=tpipe.StudyPipelineConfig(**_CONFIG), device="cpu"
    )
    ref = StudyInferencePipeline(
        CoordinateRegressor(backbone_name="resnet18", dtype=jnp.float32), trees[0],
        Classifier(backbone_name="resnet18", dtype=jnp.float32), trees[1],
        config=StudyPipelineConfig(**_CONFIG),
    )
    return port, ref


@pytest.fixture(scope="module")
def volumes(tmp_path_factory):
    """Three studies' T1 and T2 series as ``.mha`` files."""
    root = tmp_path_factory.mktemp("volumes")
    rng = np.random.default_rng(21)
    studies = []
    for i in range(3):
        pair = {}
        for series in ("t1", "t2"):
            vol = rng.normal(100, 30, (4, 80, 80)).astype(np.float32)
            path = root / f"s{i}_{series}.mha"
            tio.write_medical_image(tio.MedicalImage(array=vol, spacing=(0.45, 0.45, 3.0)), path)
            pair[series] = str(path)
        studies.append(pair)
    return studies


def _request(path, study_id, pair):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"study_id": study_id, **pair}))


def _write_requests(watch, volumes):
    for i, pair in enumerate(volumes):
        _request(watch / f"req{i}.json", f"s{i}", pair)
    (watch / "bad.json").write_text(json.dumps(_BAD))


def test_serve_matches_jax(pipelines, volumes, tmp_path):
    """The same three requests and a malformed one through both servers:
    the result JSONs agree (coords 1e-4, probabilities 5e-3, predictions
    equal), the requests land in ``done/`` and ``failed/`` alike, with the
    same error text."""
    port, ref = pipelines
    runs = {}
    for name, serve, pipe in (("port", tserve.serve_directory, port),
                              ("jax", jax_serve_directory, ref)):
        watch, out = tmp_path / name / "requests", tmp_path / name / "results"
        watch.mkdir(parents=True)
        _write_requests(watch, volumes)
        stats = serve(pipe, watch, out, once=True)
        assert (stats.processed, stats.failed, stats.batches) == (3, 1, 1), name
        assert sorted(stats.study_ids) == ["s0", "s1", "s2"]
        assert sorted(p.name for p in (watch / "done").iterdir()) == [
            "req0.json", "req1.json", "req2.json"]
        assert sorted(p.name for p in (watch / "failed").iterdir()) == [
            "bad.error.txt", "bad.json"]
        assert not list(watch.glob("*.json")) and not list((watch / "inflight").iterdir())
        runs[name] = (watch, out)
    assert ((runs["port"][0] / "failed" / "bad.error.txt").read_text()
            == (runs["jax"][0] / "failed" / "bad.error.txt").read_text())
    for i in range(3):
        got = json.loads((runs["port"][1] / f"s{i}.json").read_text())
        want = json.loads((runs["jax"][1] / f"s{i}.json").read_text())
        assert set(got) == set(want) == {"study_id", "coords", "predictions", "probabilities"}
        assert got["study_id"] == want["study_id"] == f"s{i}"
        np.testing.assert_allclose(got["coords"], want["coords"], atol=1e-4)
        assert set(got["predictions"]) == set(want["predictions"])
        for task in want["predictions"]:
            assert got["predictions"][task] == want["predictions"][task], task
            np.testing.assert_allclose(got["probabilities"][task], want["probabilities"][task],
                                       atol=5e-3, err_msg=task)


def test_serve_result_equals_run(pipelines, volumes, tmp_path):
    """A served result is ``run(..., fetch_crops=False)`` of the same files
    in the same batch, written as the payload."""
    port, _ = pipelines
    watch, out = tmp_path / "requests", tmp_path / "results"
    for i, pair in enumerate(volumes):
        _request(watch / f"req{i}.json", f"s{i}", pair)
    stats = tserve.serve_directory(port, watch, out, once=True)
    assert stats.batches == 1 and stats.processed == 3
    studies = [tpipe.study_input_from_paths(p["t1"], p["t2"], study_id=f"s{i}", device="cpu")
               for i, p in enumerate(volumes)]
    for result in port.run(studies, fetch_crops=False):
        payload = json.dumps(tserve._result_payload(result), indent=2)
        assert (out / f"{result.study_id}.json").read_text() == payload


def _owner_dirs(host):
    pid, token = os.getpid(), tserve.PROCESS_TOKEN
    other = "0" * 12 if token != "0" * 12 else "1" * 12
    call = "a" * 12
    # (claim directory name, whether recovery re-queues its claim)
    return {
        "loose": (None, True),
        "dead_pid": (f"{host}-999999999-{other}-{call}", True),
        "dead_pid_legacy": (f"{host}-999999999", True),
        "live_pid": (f"{host}-1-{other}-{call}", False),  # pid 1 always exists
        "live_pid_legacy": (f"{host}-1", False),
        "recycled_pid": (f"{host}-{pid}-{other}-{call}", True),
        "recycled_pid_legacy": (f"{host}-{pid}", True),
        "live_sibling": (f"{host}-{pid}-{token}-{call}", False),
        "foreign_host": (f"not-{host}-1234-{other}-{call}", False),
        "foreign_host_legacy": (f"not-{host}-1234", False),
        "unparseable": (f"{host}-notapid", True),
    }


@pytest.mark.parametrize("case", sorted(_owner_dirs("h")))
def test_recovery_by_owner(pipelines, volumes, tmp_path, case):
    """Startup recovery re-queues a dead server's claims (a dead pid, our
    pid under another process token, loose files at the inflight root) and
    leaves a live one's (a live pid, a live sibling in this process, a
    foreign host's)."""
    port, _ = pipelines
    host = socket.gethostname()
    name, requeued = _owner_dirs(host)[case]
    watch, out = tmp_path / "requests", tmp_path / "results"
    owner = watch / "inflight" if name is None else watch / "inflight" / name
    _request(owner / "claimed.json", "claimed", volumes[0])
    stats = tserve.serve_directory(port, watch, out, once=True)
    assert stats.processed == int(requeued)
    assert (out / "claimed.json").exists() == requeued
    assert (owner / "claimed.json").exists() == (not requeued)
    if name is not None:
        assert owner.exists() == (not requeued)  # a recovered owner's directory is removed
    # The server's own claim directory is gone again.
    left = [p.name for p in (watch / "inflight").iterdir()]
    assert left == ([] if requeued or name is None else [name])


def test_live_sibling_claim_survives_a_second_server(pipelines, volumes, tmp_path):
    """A live server's claim in this process survives a second server's
    start. The JAX package names both servers' claim directories
    ``<host>-<pid>``, so its second server re-queues the first one's claim
    and serves it a second time; the port's per-call names keep it."""
    port, ref = pipelines
    host = socket.gethostname()
    # The port: the sibling's claim directory as serve_directory names it.
    watch, out = tmp_path / "port" / "requests", tmp_path / "port" / "results"
    sibling = watch / "inflight" / f"{host}-{os.getpid()}-{tserve.PROCESS_TOKEN}-{'b' * 12}"
    _request(sibling / "claimed.json", "claimed", volumes[0])
    _request(watch / "new.json", "new", volumes[1])
    stats = tserve.serve_directory(port, watch, out, once=True)
    assert stats.study_ids == ["new"]
    assert (sibling / "claimed.json").exists() and not (out / "claimed.json").exists()
    # The JAX package: its sibling's directory is its own name; a malformed
    # claim keeps its JAX pipeline from compiling.
    watch, out = tmp_path / "jax" / "requests", tmp_path / "jax" / "results"
    sibling = watch / "inflight" / f"{host}-{os.getpid()}"
    sibling.mkdir(parents=True)
    (sibling / "claimed.json").write_text(json.dumps(_BAD))
    stats = jax_serve_directory(ref, watch, out, once=True)
    assert not (sibling / "claimed.json").exists()
    assert stats.failed == 1 and (watch / "failed" / "claimed.json").exists()


def test_two_servers_share_one_watch_dir(pipelines, volumes, tmp_path):
    """Two servers on one pipeline and one watch directory serve each
    request exactly once, each result equal to the one-server run's."""
    port, _ = pipelines
    one_watch, one_out = tmp_path / "one" / "requests", tmp_path / "one" / "results"
    watch, out = tmp_path / "two" / "requests", tmp_path / "two" / "results"
    n = 6
    for i in range(n):
        for w in (one_watch, watch):
            _request(w / f"r{i}.json", f"s{i}", volumes[i % 3])
    tserve.serve_directory(port, one_watch, one_out, once=True, max_batch=2)
    stats = [None, None]

    def server(idx):
        stats[idx] = tserve.serve_directory(port, watch, out, once=True, max_batch=2)

    threads = [threading.Thread(target=server, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    # once=True: a server whose first claim loses every rename stops at once.
    assert stats[0].processed + stats[1].processed == n
    assert sorted(stats[0].study_ids + stats[1].study_ids) == [f"s{i}" for i in range(n)]
    assert sorted(p.name for p in (watch / "done").iterdir()) == [f"r{i}.json" for i in range(n)]
    assert not list(watch.glob("*.json")) and not list((watch / "inflight").iterdir())
    for i in range(n):
        got = json.loads((out / f"s{i}.json").read_text())
        want = json.loads((one_out / f"s{i}.json").read_text())
        assert got["predictions"] == want["predictions"]
        np.testing.assert_allclose(got["coords"], want["coords"], rtol=0, atol=1e-6)


def test_stop_event_returns_the_prefetched_claim(pipelines, volumes, tmp_path):
    """With the stop event set, the server serves the batch in hand and puts
    the batch its prefetch thread claimed back into the watch directory."""
    port, _ = pipelines
    watch, out = tmp_path / "requests", tmp_path / "results"
    for i, pair in enumerate(volumes):
        _request(watch / f"req{i}.json", f"s{i}", pair)
    stop = threading.Event()
    stop.set()
    stats = tserve.serve_directory(port, watch, out, max_batch=1, stop_event=stop)
    assert stats.processed == 1 and stats.batches == 1
    assert len(list(watch.glob("*.json"))) == 2
    assert not list((watch / "inflight").iterdir())
