"""Time a policy publication (``plane/publish.PolicyPublisher``) on this host.

    python -m sheeprl_tpu_torch.tools.bench_publish [--versions 500] [--learner-ms 4] [--dir DIR]

Publishes SAC's actor at its preset width (hidden 256: the version the
decoupled SAC learner publishes every update) and prints one JSON line:

- ``sync_write_ms``: one version written on the caller's thread (the npz,
  the manifest, their fsyncs, the rename, the collection of old versions);
- ``file_fsync_ms``, ``dir_fsync_ms``: the medians of fsyncing a file of the
  version's size, and of a directory, on the same filesystem;
- for each writer (``none``: no publication, ``thread``, ``process``): the
  milliseconds an update takes when a loop of ``--learner-ms`` of Python
  work publishes a version after each update, and the part of it blocked
  in ``publish`` (the writer's queue of 8 full), the writer started and
  its first version written before the timing.

Writes under ``--dir`` (the temporary directory by default) and removes
what it wrote. Needs no card.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import shutil
import statistics
import tempfile
import time


def _loop(publisher, params, versions: int, learner_ms: float) -> dict:
    if publisher is not None:  # the writer started and its first version landed, outside the timing
        from sheeprl_tpu_torch.plane.publish import policy_path

        publisher.publish(0, params)
        deadline = time.monotonic() + 60
        while not os.path.isdir(policy_path(publisher.root, 0)) and time.monotonic() < deadline:
            time.sleep(0.01)
    t0, blocked = time.perf_counter(), 0.0
    for version in range(1, versions + 1):
        end = time.perf_counter() + learner_ms / 1e3
        x = 0
        while time.perf_counter() < end:  # the learner's own Python work
            x += sum(range(100))
        if publisher is not None:
            t = time.perf_counter()
            publisher.publish(version, params)
            blocked += time.perf_counter() - t
    if publisher is not None:
        publisher.close()
    return {"ms_per_update": (time.perf_counter() - t0) / versions * 1e3, "blocked_ms_per_update": blocked / versions * 1e3}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--versions", type=int, default=500)
    parser.add_argument("--learner-ms", type=float, default=4.0)
    parser.add_argument("--dir", default=None)
    args = parser.parse_args(argv)

    from sheeprl_tpu_torch.algos.sac.agent import SACActor
    from sheeprl_tpu_torch.algos.sac.sac_decoupled import host_params
    from sheeprl_tpu_torch.plane.publish import PolicyPublisher

    params = host_params(SACActor(3, 1, 256))
    root = tempfile.mkdtemp(prefix="bench_publish_", dir=args.dir)
    try:
        out = {"version_bytes": int(sum(v.nbytes for v in params.values())), "dir": root}
        sync = PolicyPublisher(os.path.join(root, "sync"), algo="sac_decoupled")
        t0 = time.perf_counter()
        for version in range(200):
            sync._write(version, params)
        out["sync_write_ms"] = (time.perf_counter() - t0) / 200 * 1e3
        blob, file_s, dir_s = os.urandom(out["version_bytes"]), [], []
        for _ in range(50):
            t = time.perf_counter()
            with open(os.path.join(root, "blob"), "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            file_s.append(time.perf_counter() - t)
            t = time.perf_counter()
            fd = os.open(root, os.O_RDONLY)
            os.fsync(fd)
            os.close(fd)
            dir_s.append(time.perf_counter() - t)
        out["file_fsync_ms"] = statistics.median(file_s) * 1e3
        out["dir_fsync_ms"] = statistics.median(dir_s) * 1e3
        for writer in ("none", "thread", "process"):
            publisher = None if writer == "none" else PolicyPublisher(
                os.path.join(root, writer), algo="sac_decoupled", async_publish=True,
                mp_context=mp.get_context("forkserver") if writer == "process" else None)
            out[writer] = _loop(publisher, params, args.versions, args.learner_ms)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print("[bench_publish] " + json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
