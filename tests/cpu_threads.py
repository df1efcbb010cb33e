"""One CPU thread for PyTorch in every process of the port's tests.

The suite runs on pytest-xdist workers (``-n 6`` on an 8-core host), and
PyTorch's intra-op pool defaults to one OpenMP thread a core in every
worker and in every process a test starts (a CLI run in a fresh
interpreter, a plane player, a ring client, the in-run eval child): six
workers ask for 48 spinning threads on 8 cores. Under that load a 0.43 ms
convolution of the SAC-AE encoder took 58 ms, and twelve of the port's
heaviest files took 2,442 test-seconds (482 s on 6 workers) against 352
(102 s) with one thread a process, measured on one 8-core host.

Importing this module caps the importing process at one thread
(``torch.set_num_threads``) and sets ``OMP_NUM_THREADS=1`` for the
processes it starts, unless the caller chose a count. A worker imports
every test file while it collects, before any test runs, so one import by
any collected file caps the whole worker. No check depends on it: a test
that compares two computations runs both at the same count, and the
plane's players and learner set their acting threads themselves
(``plane.worker.ACTING_THREADS``).
"""

import os

os.environ.setdefault("OMP_NUM_THREADS", "1")

import torch  # noqa: E402

torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
