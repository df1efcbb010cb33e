"""A load-generating ring client: the ``serve.clients.entry`` a serve
command spawns to drive itself (``sheeprl-tpu-torch-serve ...
serve.clients.n=64 serve.clients.entry=sheeprl_tpu_torch.serve.loadgen:seeded_client
serve.clients.spec.out_dir=<dir> serve.clients.spec.duration_s=10``).

Each client sends seeded observation rows (uint8 frames, Gaussian vectors,
shaped by the ring's slabs) back to back until ``duration_s`` seconds have
passed, ``requests`` requests are answered or the file ``stop_file``
exists, starting a new episode every ``episode_len`` requests. After its
first answer it creates ``<out_dir>/client_<slot>.started``; at the end it
writes what it saw to ``<out_dir>/client_<slot>.json``: per request the
wall-clock time of the answer, its latency and the model version, the
errors, and whether the process had loaded torch (it never should: the ring
and the client are numpy).
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict

import numpy as np

__all__ = ["seeded_client"]


def seeded_client(client, spec: Dict[str, Any]) -> None:
    ring = client._ring
    rng = np.random.default_rng(int(spec.get("seed", 0)) * 100_003 + client.slot)
    duration_s = float(spec.get("duration_s", 0.0) or 0.0)
    max_requests = int(spec.get("requests", 0) or 0)
    episode_len = max(int(spec.get("episode_len", 16) or 16), 1)
    answered_at, latency_s, versions, errors = [], [], [], []
    stop_file = spec.get("stop_file", None)
    out_dir = str(spec["out_dir"])
    os.makedirs(out_dir, exist_ok=True)
    t_end = time.monotonic() + duration_s if duration_s else None
    i = 0
    while (t_end is None or time.monotonic() < t_end) and (not max_requests or i < max_requests):
        if stop_file and os.path.exists(stop_file):
            break
        obs = {
            k: rng.integers(0, 256, shape, dtype=np.uint8) if dtype == np.uint8 else rng.standard_normal(shape).astype(dtype)
            for k, (shape, dtype) in ring.obs_spec.items()
        }
        t0 = time.monotonic()
        try:
            _action, version = client.act(obs, reset=i % episode_len == 0, timeout=60.0)
        except Exception as exc:  # recorded: the caller fails the run on any error
            errors.append(f"{type(exc).__name__}: {exc}")
            break
        latency_s.append(time.monotonic() - t0)
        answered_at.append(time.time())
        versions.append(int(version))
        if i == 0:
            open(os.path.join(out_dir, f"client_{client.slot}.started"), "w").close()
        i += 1
    path = os.path.join(out_dir, f"client_{client.slot}.json")
    with open(path + ".tmp", "w") as f:
        json.dump({"slot": client.slot, "answered_at": answered_at, "latency_s": latency_s, "versions": versions,
                   "errors": errors, "torch_loaded": "torch" in sys.modules}, f)
    os.replace(path + ".tmp", path)
