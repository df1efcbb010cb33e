"""Host-side numpy replay buffers (counterpart of ``ReplayBuffer``,
``SequentialReplayBuffer``, ``EpisodeBuffer`` and
``EnvIndependentReplayBuffer`` in ``sheeprl_tpu/data/buffers.py``).

Storage is a dict of ``[buffer_size, n_envs, ...]`` arrays (optionally
memory-mapped); sampling draws from the buffer's own numpy ``Generator``
(:meth:`seed`) with the JAX package's formulas, so the same adds and seed
give the same samples in both packages. Batches stay numpy: the staging
layer (:mod:`sheeprl_tpu_torch.data.staging`) copies them to the device.
"""

from __future__ import annotations

import os
import uuid
from contextlib import nullcontext
from typing import Any, Dict, List, Optional, Sequence, Tuple, Type, Union

import numpy as np

from sheeprl_tpu_torch.utils.memmap import MemmapArray, validate_memmap_mode

__all__ = ["EnvIndependentReplayBuffer", "EpisodeBuffer", "ReplayBuffer", "SequentialReplayBuffer", "end_biased_start"]

Arrays = Dict[str, Union[np.ndarray, MemmapArray]]


def _as_np(v: Union[np.ndarray, MemmapArray]) -> np.ndarray:
    return v.array if isinstance(v, MemmapArray) else v


def end_biased_start(rng: np.random.Generator, length: int, upper: int) -> int:
    """One end-biased window start (``prioritize_ends``): uniform over
    ``[0, length)`` clamped to the last valid start ``upper``, so the
    clamped tail's mass piles onto the episode's last window."""
    return min(int(rng.integers(0, length)), upper)


class ReplayBuffer:
    """Uniform-sampling ring buffer of shape ``[buffer_size, n_envs, ...]``."""

    def __init__(
        self,
        buffer_size: int,
        n_envs: int = 1,
        obs_keys: Sequence[str] = ("observations",),
        memmap: bool = False,
        memmap_dir: Optional[Union[str, os.PathLike]] = None,
        memmap_mode: str = "r+",
        **kwargs: Any,
    ):
        if buffer_size <= 0:
            raise ValueError(f"The buffer size must be greater than zero, got: {buffer_size}")
        if n_envs <= 0:
            raise ValueError(f"The number of environments must be greater than zero, got: {n_envs}")
        if isinstance(obs_keys, str):
            obs_keys = (obs_keys,)
        self._buffer_size = buffer_size
        self._n_envs = n_envs
        self._obs_keys = tuple(obs_keys)
        self._memmap = memmap
        self._memmap_dir = os.fspath(memmap_dir) if memmap_dir is not None else None
        if memmap:
            validate_memmap_mode(memmap_mode)
            if self._memmap_dir is None:
                raise ValueError(
                    "The buffer is set to be memory-mapped but the 'memmap_dir' attribute is None. "
                    "Please provide a directory where to save the buffer files."
                )
            os.makedirs(self._memmap_dir, exist_ok=True)
        self._memmap_mode = memmap_mode
        self._buf: Optional[Arrays] = None
        self._pos = 0
        self._full = False
        self._rng: np.random.Generator = np.random.default_rng()
        self._write_lock: Optional[Any] = None

    # -- properties -------------------------------------------------------

    @property
    def buffer(self) -> Optional[Arrays]:
        return self._buf

    @property
    def buffer_size(self) -> int:
        return self._buffer_size

    @property
    def n_envs(self) -> int:
        return self._n_envs

    @property
    def full(self) -> bool:
        return self._full

    @property
    def empty(self) -> bool:
        return self._buf is None

    def seed(self, seed: Optional[int] = None) -> None:
        self._rng = np.random.default_rng(seed)

    def bind_write_lock(self, lock: Any) -> None:
        """Serialize ``add`` against a background sampler (the staging's
        prefetch thread)."""
        self._write_lock = lock

    # -- storage ----------------------------------------------------------

    def _allocate(self, data: Dict[str, np.ndarray]) -> None:
        self._buf = {}
        for k, v in data.items():
            shape = (self._buffer_size, self._n_envs) + v.shape[2:]
            if self._memmap:
                self._buf[k] = MemmapArray(
                    shape=shape,
                    dtype=v.dtype,
                    filename=os.path.join(self._memmap_dir, f"{k}.memmap"),
                    mode=self._memmap_mode,
                )
            else:
                self._buf[k] = np.empty(shape, dtype=v.dtype)

    def add(self, data: Dict[str, np.ndarray]) -> None:
        """Insert ``[T, n_envs, ...]`` steps with ring wrap-around."""
        data = {k: np.asarray(v) for k, v in data.items()}
        data_len = next(iter(data.values())).shape[0]
        with self._write_lock or nullcontext():
            if self._buf is None:
                self._allocate(data)
            next_pos = (self._pos + data_len) % self._buffer_size
            # only the trailing window survives, written where it would have
            # landed had every step been inserted one by one
            write_len = min(data_len, self._buffer_size)
            start = self._pos + data_len - write_len
            idxes = np.arange(start, start + write_len) % self._buffer_size
            for k, v in data.items():
                self._buf[k][idxes] = v[-write_len:]
            if self._pos + data_len >= self._buffer_size:
                self._full = True
            self._pos = next_pos

    # -- sampling ---------------------------------------------------------

    def _valid_time_indices(self, sample_next_obs: bool) -> np.ndarray:
        if sample_next_obs:
            # the newest element has no stored successor
            if self._full:
                return np.delete(np.arange(self._buffer_size), (self._pos - 1) % self._buffer_size)
            return np.arange(self._pos - 1)
        if self._full:
            return np.arange(self._buffer_size)
        return np.arange(self._pos)

    def sample(
        self,
        batch_size: int,
        sample_next_obs: bool = False,
        clone: bool = False,
        n_samples: int = 1,
        **kwargs: Any,
    ) -> Dict[str, np.ndarray]:
        """Uniformly sample ``[n_samples, batch_size, ...]`` transitions."""
        if batch_size <= 0 or n_samples <= 0:
            raise ValueError(f"'batch_size' ({batch_size}) and 'n_samples' ({n_samples}) must be both greater than 0")
        if self._buf is None or (not self._full and self._pos == 0):
            raise ValueError("No sample has been added to the buffer")
        valid = self._valid_time_indices(sample_next_obs)
        if len(valid) == 0:
            raise RuntimeError(
                "You want to sample the next observations, but only one sample has been added to the buffer. "
                "Make sure that at least two samples are added."
            )
        total = batch_size * n_samples
        t_idx = valid[self._rng.integers(0, len(valid), size=total)]
        e_idx = self._rng.integers(0, self._n_envs, size=total)
        out: Dict[str, np.ndarray] = {}
        for k, v in self._buf.items():
            arr = _as_np(v)
            sel = arr[t_idx, e_idx]
            out[k] = np.array(sel) if clone else sel
            if sample_next_obs and k in self._obs_keys:
                nxt = arr[(t_idx + 1) % self._buffer_size, e_idx]
                out[f"next_{k}"] = np.array(nxt) if clone else nxt
        return {k: v.reshape(n_samples, batch_size, *v.shape[1:]) for k, v in out.items()}

    # -- dict access ------------------------------------------------------

    def __getitem__(self, key: str) -> np.ndarray:
        if not isinstance(key, str):
            raise TypeError("'key' must be a string")
        if self._buf is None:
            raise RuntimeError("The buffer has not been initialized. Try to add some data first.")
        return self._buf[key]

    def __contains__(self, key: str) -> bool:
        return self._buf is not None and key in self._buf

    # -- checkpointing ----------------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        return {
            "buffer": {k: np.array(_as_np(v)) for k, v in (self._buf or {}).items()},
            "pos": self._pos,
            "full": self._full,
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        buf = state["buffer"]
        if buf:
            if self._buf is None:
                self._allocate(buf)  # stored arrays are already [size, n_envs, ...]
            for k, v in buf.items():
                self._buf[k][...] = v
        self._pos = int(state["pos"])
        self._full = bool(state["full"])


class SequentialReplayBuffer(ReplayBuffer):
    """Ring buffer sampling *contiguous* sequences ``[n_samples, seq_len,
    batch, ...]``. Valid starts never straddle the write head; once full,
    sequences may wrap around the end of storage."""

    def _plan_starts(self, total: int, sequence_length: int, effective_len: int) -> np.ndarray:
        if self._full:
            max_offset = self._buffer_size - effective_len
            if max_offset < 0:
                raise ValueError(
                    f"Cannot sample a sequence of length {sequence_length} from a buffer of size {self._buffer_size}"
                )
            return (self._pos + self._rng.integers(0, max_offset + 1, size=total)) % self._buffer_size
        max_start = self._pos - effective_len
        if max_start < 0:
            raise ValueError(
                f"Cannot sample a sequence of length {sequence_length}: the buffer only contains {self._pos} steps"
            )
        return self._rng.integers(0, max_start + 1, size=total)

    def sample(
        self,
        batch_size: int,
        sample_next_obs: bool = False,
        clone: bool = False,
        n_samples: int = 1,
        sequence_length: int = 1,
        **kwargs: Any,
    ) -> Dict[str, np.ndarray]:
        if batch_size <= 0 or n_samples <= 0:
            raise ValueError(f"'batch_size' ({batch_size}) and 'n_samples' ({n_samples}) must be both greater than 0")
        if sequence_length <= 0:
            raise ValueError(f"'sequence_length' ({sequence_length}) must be greater than 0")
        if self._buf is None or (not self._full and self._pos == 0):
            raise ValueError("No sample has been added to the buffer")
        effective_len = sequence_length + (1 if sample_next_obs else 0)
        total = batch_size * n_samples
        starts = self._plan_starts(total, sequence_length, effective_len)
        e_idx = self._rng.integers(0, self._n_envs, size=total)
        # [total, seq_len] absolute time indices (wrap-around safe)
        seq = (starts[:, None] + np.arange(sequence_length)[None, :]) % self._buffer_size
        out: Dict[str, np.ndarray] = {}
        for k, v in self._buf.items():
            arr = _as_np(v)
            sel = arr[seq, e_idx[:, None]].reshape(n_samples, batch_size, sequence_length, *arr.shape[2:])
            out[k] = np.array(sel.swapaxes(1, 2)) if clone else sel.swapaxes(1, 2)
            if sample_next_obs and k in self._obs_keys:
                nsel = arr[(seq + 1) % self._buffer_size, e_idx[:, None]]
                nsel = nsel.reshape(n_samples, batch_size, sequence_length, *arr.shape[2:])
                out[f"next_{k}"] = np.array(nsel.swapaxes(1, 2)) if clone else nsel.swapaxes(1, 2)
        return out


class EnvIndependentReplayBuffer:
    """One sub-buffer per environment: ``add(data, env_idxes)`` routes
    columns to specific envs, sampling draws a balanced mix over the envs
    that hold data."""

    def __init__(
        self,
        buffer_size: int,
        n_envs: int = 1,
        obs_keys: Sequence[str] = ("observations",),
        memmap: bool = False,
        memmap_dir: Optional[Union[str, os.PathLike]] = None,
        memmap_mode: str = "r+",
        buffer_cls: Type[ReplayBuffer] = ReplayBuffer,
        **kwargs: Any,
    ):
        if buffer_size <= 0:
            raise ValueError(f"The buffer size must be greater than zero, got: {buffer_size}")
        if n_envs <= 0:
            raise ValueError(f"The number of environments must be greater than zero, got: {n_envs}")
        if memmap:
            validate_memmap_mode(memmap_mode)
            if memmap_dir is None:
                raise ValueError(
                    "The buffer is set to be memory-mapped but the 'memmap_dir' attribute is None. "
                    "Please provide a directory where to save the buffer files."
                )
        self._buffer_size = buffer_size
        self._n_envs = n_envs
        self._concat_along_axis = 2 if issubclass(buffer_cls, SequentialReplayBuffer) else 1
        self._rng: np.random.Generator = np.random.default_rng()
        self._write_lock: Optional[Any] = None
        self._buf: List[ReplayBuffer] = [
            buffer_cls(
                buffer_size,
                n_envs=1,
                obs_keys=obs_keys,
                memmap=memmap,
                memmap_dir=os.path.join(os.fspath(memmap_dir), f"env_{i}") if memmap_dir else None,
                memmap_mode=memmap_mode,
                **kwargs,
            )
            for i in range(n_envs)
        ]

    @property
    def buffer(self) -> List[ReplayBuffer]:
        return self._buf

    @property
    def buffer_size(self) -> int:
        return self._buffer_size

    @property
    def n_envs(self) -> int:
        return self._n_envs

    @property
    def full(self) -> bool:
        return all(b.full for b in self._buf)

    def seed(self, seed: Optional[int] = None) -> None:
        # the env-mix generator is offset past the sub-buffers' seeds
        self._rng = np.random.default_rng(None if seed is None else seed + self._n_envs)
        for i, b in enumerate(self._buf):
            b.seed(None if seed is None else seed + i)

    def bind_write_lock(self, lock: Any) -> None:
        self._write_lock = lock

    def add(self, data: Dict[str, np.ndarray], env_idxes: Optional[Sequence[int]] = None) -> None:
        n_cols = next(iter(data.values())).shape[1]
        if env_idxes is None:
            env_idxes = list(range(self._n_envs))
        if n_cols != len(env_idxes):
            raise ValueError(f"Cannot add data with {n_cols} env columns to {len(env_idxes)} env indices")
        for idx in env_idxes:
            if idx < 0 or idx >= self._n_envs:
                raise ValueError(f"The indices of the environment must be integers in [0, {self._n_envs}), given {idx}")
        with self._write_lock or nullcontext():
            for col, env in enumerate(env_idxes):
                self._buf[env].add({k: np.asarray(v)[:, col : col + 1] for k, v in data.items()})

    def _pick_envs(self, batch_size: int) -> Tuple[List[int], np.ndarray]:
        with_data = [i for i, b in enumerate(self._buf) if not b.empty and (b.full or b._pos > 0)]
        if not with_data:
            raise ValueError("No sample has been added to the buffer")
        picks = self._rng.integers(0, len(with_data), size=batch_size)
        return with_data, np.bincount(picks, minlength=len(with_data))

    def sample(self, batch_size: int, n_samples: int = 1, **kwargs: Any) -> Dict[str, np.ndarray]:
        if batch_size <= 0 or n_samples <= 0:
            raise ValueError(f"'batch_size' ({batch_size}) and 'n_samples' ({n_samples}) must be both greater than 0")
        with_data, counts = self._pick_envs(batch_size)
        parts = [
            self._buf[env].sample(int(counts[j]), n_samples=n_samples, **kwargs)
            for j, env in enumerate(with_data)
            if counts[j]
        ]
        return {k: np.concatenate([p[k] for p in parts], axis=self._concat_along_axis) for k in parts[0]}

    def state_dict(self) -> Dict[str, Any]:
        return {"buffers": [b.state_dict() for b in self._buf]}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        for b, s in zip(self._buf, state["buffers"]):
            b.load_state_dict(s)


class EpisodeBuffer:
    """Whole-episode storage. Episodes are closed by ``dones`` (each env's
    steps collect in its open episode until then); only episodes of length
    in ``[sequence_length, buffer_size]`` are kept, the oldest evicted first
    once the stored steps would pass ``buffer_size``. ``sample`` returns
    ``[n_samples, sequence_length, batch, ...]`` windows, optionally biased
    toward episode ends (``prioritize_ends``). With ``memmap`` every stored
    episode is its own directory of memory-mapped files, removed on
    eviction."""

    def __init__(
        self,
        buffer_size: int,
        sequence_length: int,
        n_envs: int = 1,
        obs_keys: Sequence[str] = ("observations",),
        prioritize_ends: bool = False,
        memmap: bool = False,
        memmap_dir: Optional[Union[str, os.PathLike]] = None,
        memmap_mode: str = "r+",
    ):
        if buffer_size <= 0:
            raise ValueError(f"The buffer size must be greater than zero, got: {buffer_size}")
        if sequence_length <= 0:
            raise ValueError(f"The sequence length must be greater than zero, got: {sequence_length}")
        if buffer_size < sequence_length:
            raise ValueError(
                f"The sequence length must be lower than the buffer size, got: bs = {buffer_size}"
                f" and sl = {sequence_length}"
            )
        if isinstance(obs_keys, str):
            obs_keys = (obs_keys,)
        self._buffer_size = buffer_size
        self._sequence_length = sequence_length
        self._n_envs = n_envs
        self._obs_keys = tuple(obs_keys)
        self._prioritize_ends = prioritize_ends
        self._memmap = memmap
        self._memmap_dir = os.fspath(memmap_dir) if memmap_dir is not None else None
        if memmap:
            validate_memmap_mode(memmap_mode)
            if self._memmap_dir is None:
                raise ValueError(
                    "The buffer is set to be memory-mapped but the 'memmap_dir' attribute is None. "
                    "Please provide a directory where to save the buffer files."
                )
            os.makedirs(self._memmap_dir, exist_ok=True)
        self._memmap_mode = memmap_mode
        self._buf: List[Arrays] = []
        self._open_episodes: List[List[Dict[str, np.ndarray]]] = [[] for _ in range(n_envs)]
        self._cum_steps = 0  # steps stored, kept by save_episode and eviction
        self._rng: np.random.Generator = np.random.default_rng()
        self._write_lock: Optional[Any] = None

    # -- properties -------------------------------------------------------

    @property
    def buffer(self) -> List[Arrays]:
        return self._buf

    @property
    def buffer_size(self) -> int:
        return self._buffer_size

    @property
    def sequence_length(self) -> int:
        return self._sequence_length

    @property
    def n_envs(self) -> int:
        return self._n_envs

    @property
    def prioritize_ends(self) -> bool:
        return self._prioritize_ends

    @property
    def is_memmap(self) -> bool:
        return self._memmap

    @property
    def full(self) -> bool:
        return self._buffer_size - self._cum_steps < self._sequence_length

    def __len__(self) -> int:
        return len(self._buf)

    def seed(self, seed: Optional[int] = None) -> None:
        self._rng = np.random.default_rng(seed)

    def bind_write_lock(self, lock: Any) -> None:
        """Serialize ``add`` against a background sampler (the staging's
        prefetch thread)."""
        self._write_lock = lock

    # -- insertion --------------------------------------------------------

    def add(self, data: Dict[str, np.ndarray], env_idxes: Optional[Sequence[int]] = None) -> None:
        """Append ``[T, n_cols, ...]`` steps, column ``j`` to env
        ``env_idxes[j]`` (all envs in order when None); a ``done`` closes
        that env's episode."""
        if "dones" not in data:
            raise RuntimeError(f"The episode must contain the `dones` key, got: {set(data.keys())}")
        n_cols = next(iter(data.values())).shape[1]
        if env_idxes is None:
            env_idxes = list(range(n_cols))
        if n_cols != len(env_idxes):
            raise RuntimeError(f"`data` has {n_cols} env columns but {len(env_idxes)} env indices were given")
        for idx in env_idxes:
            if idx < 0 or idx >= self._n_envs:
                raise ValueError(f"The indices of the environment must be integers in [0, {self._n_envs}), given {idx}")
        with self._write_lock or nullcontext():
            for col, env in enumerate(env_idxes):
                self._add_env_chunk({k: np.asarray(v)[:, col] for k, v in data.items()}, env)

    def _add_env_chunk(self, chunk: Dict[str, np.ndarray], env: int) -> None:
        dones = chunk["dones"].reshape(len(chunk["dones"]), -1)[:, 0]
        start = 0
        for t in np.flatnonzero(dones > 0):
            self._open_episodes[env].append({k: v[start : t + 1] for k, v in chunk.items()})
            start = t + 1
            self._close_episode(env)
        if start < len(dones):
            self._open_episodes[env].append({k: v[start:] for k, v in chunk.items()})

    def _close_episode(self, env: int) -> None:
        chunks, self._open_episodes[env] = self._open_episodes[env], []
        if chunks and sum(len(c["dones"]) for c in chunks) >= self._sequence_length:
            self.save_episode(chunks)

    def save_episode(self, episode_chunks: Union[Dict[str, np.ndarray], List[Dict[str, np.ndarray]]]) -> None:
        """Validate and store one finished episode (a dict or a list of chunks)."""
        if isinstance(episode_chunks, dict):
            episode_chunks = [episode_chunks]
        if len(episode_chunks) == 0:
            raise RuntimeError("The episode must contain at least one step")
        episode = {k: np.concatenate([np.asarray(c[k]) for c in episode_chunks], axis=0) for k in episode_chunks[0]}
        dones = episode["dones"].reshape(len(episode["dones"]), -1)[:, 0]
        if dones.sum() != 1:
            raise RuntimeError(f"The episode must contain exactly one done, got: {int(dones.sum())}")
        if dones[-1] != 1:
            raise RuntimeError("The last step must contain a done, got: 0")
        ep_len = len(dones)
        if ep_len < self._sequence_length or ep_len > self._buffer_size:
            raise RuntimeError(
                f"Invalid episode length: the episode length ({ep_len}) must be at least "
                f"sequence_length ({self._sequence_length}) and at most buffer_size ({self._buffer_size})"
            )
        while self._cum_steps + ep_len > self._buffer_size and self._buf:
            self._evict_oldest()
        self._buf.append(self._stored(episode))
        self._cum_steps += ep_len

    def _stored(self, episode: Dict[str, np.ndarray]) -> Arrays:
        if not self._memmap:
            return episode
        ep_dir = os.path.join(self._memmap_dir, f"episode_{uuid.uuid4().hex}")
        return {
            k: MemmapArray.from_array(v, filename=os.path.join(ep_dir, f"{k}.memmap"), mode=self._memmap_mode)
            for k, v in episode.items()
        }

    def _evict_oldest(self) -> None:
        old = self._buf.pop(0)
        self._cum_steps -= len(_as_np(old["dones"]))
        dirs = {os.path.dirname(v.filename) for v in old.values() if isinstance(v, MemmapArray)}
        for v in old.values():
            if isinstance(v, MemmapArray):
                v.__del__()  # unlinks the file now, not when the last view goes
        old.clear()
        for d in dirs:
            try:
                os.rmdir(d)
            except OSError:
                pass

    # -- sampling ---------------------------------------------------------

    def sample(
        self,
        batch_size: int,
        n_samples: int = 1,
        clone: bool = False,
        sample_next_obs: bool = False,
        prioritize_ends: Optional[bool] = None,
        **kwargs: Any,
    ) -> Dict[str, np.ndarray]:
        """``[n_samples, sequence_length, batch_size, ...]`` windows: an
        episode uniformly among those long enough, then a start in it
        (end-biased with ``prioritize_ends``)."""
        if batch_size <= 0 or n_samples <= 0:
            raise ValueError(f"'batch_size' ({batch_size}) and 'n_samples' ({n_samples}) must be both greater than 0")
        if len(self._buf) == 0:
            raise ValueError("No sample has been added to the buffer")
        if prioritize_ends is None:
            prioritize_ends = self._prioritize_ends
        sl = self._sequence_length
        effective = sl + (1 if sample_next_obs else 0)
        lengths = np.array([len(_as_np(ep["dones"])) for ep in self._buf])
        eligible = np.flatnonzero(lengths >= effective)
        if len(eligible) == 0:
            raise ValueError(f"No episode long enough to sample sequences of length {sl}")
        chosen = eligible[self._rng.integers(0, len(eligible), size=batch_size * n_samples)]
        out: Dict[str, List[np.ndarray]] = {}
        for i in chosen:
            ep, ep_len = self._buf[i], int(lengths[i])
            upper = ep_len - effective  # the last valid start
            if prioritize_ends:
                start = end_biased_start(self._rng, ep_len, upper)
            else:
                start = int(self._rng.integers(0, upper + 1))
            for k in ep:
                arr = _as_np(ep[k])
                out.setdefault(k, []).append(arr[start : start + sl])
                if sample_next_obs and k in self._obs_keys:
                    out.setdefault(f"next_{k}", []).append(arr[start + 1 : start + sl + 1])
        stacked = {}
        for k, vs in out.items():
            arr = np.stack(vs, axis=0).reshape(n_samples, batch_size, sl, *vs[0].shape[1:]).swapaxes(1, 2)
            stacked[k] = np.array(arr) if clone else arr
        return stacked

    # -- checkpointing ----------------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        """The stored episodes and every env's open episode, as numpy copies."""
        return {
            "buffer": [{k: np.array(_as_np(v)) for k, v in ep.items()} for ep in self._buf],
            "open_episodes": [
                [{k: np.array(v) for k, v in chunk.items()} for chunk in env_chunks]
                for env_chunks in self._open_episodes
            ],
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self._buf = [self._stored({k: np.asarray(v) for k, v in ep.items()}) for ep in state["buffer"]]
        self._cum_steps = sum(len(_as_np(ep["dones"])) for ep in self._buf)
        self._open_episodes = [
            [{k: np.array(v) for k, v in chunk.items()} for chunk in env_chunks]
            for env_chunks in state.get("open_episodes", [[] for _ in range(self._n_envs)])
        ]
