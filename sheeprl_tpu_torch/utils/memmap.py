"""Disk-backed numpy arrays (counterpart of ``sheeprl_tpu/utils/memmap.py``).

An ownership-tracking wrapper over ``np.memmap`` (the instance that made
the file unlinks it when it goes): the replay buffer's storage when
``buffer.memmap=True``. Observations live on disk and
in the host's page cache; only sampled batches are copied to the device.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Union

import numpy as np

ACCEPTED_MEMMAP_MODES = ("r+", "w+")


def validate_memmap_mode(mode: str) -> str:
    if mode not in ACCEPTED_MEMMAP_MODES:
        raise ValueError(
            f"Accepted values for memmap_mode are {ACCEPTED_MEMMAP_MODES}, got '{mode}'"
        )
    return mode


class MemmapArray:
    """A numpy array backed by the file ``filename``, which this instance
    owns and unlinks when it is deleted. ``mode="r+"`` reopens an existing
    file of that name, ``"w+"`` starts it anew."""

    def __init__(
        self,
        shape: Sequence[int],
        dtype: Union[np.dtype, type] = np.float32,
        filename: str = "",
        mode: str = "r+",
    ):
        validate_memmap_mode(mode)
        self._shape = tuple(int(s) for s in shape)
        self._dtype = np.dtype(dtype)
        self._filename = os.path.abspath(filename)
        self._has_ownership = True
        self._array: Optional[np.memmap] = None
        os.makedirs(os.path.dirname(self._filename), exist_ok=True)
        existed = os.path.isfile(self._filename)
        self._array = np.memmap(
            self._filename,
            dtype=self._dtype,
            mode="r+" if existed and mode == "r+" else "w+",
            shape=self._shape,
        )

    @classmethod
    def from_array(cls, array: Union[np.ndarray, "MemmapArray"], filename: str, mode: str = "r+") -> "MemmapArray":
        """A new file ``filename`` holding a copy of ``array``."""
        array = np.asarray(array.array if isinstance(array, MemmapArray) else array)
        out = cls(shape=array.shape, dtype=array.dtype, filename=filename, mode=mode)
        out._array[...] = array
        out._array.flush()
        return out

    # -- core accessors ---------------------------------------------------

    @property
    def array(self) -> np.memmap:
        if self._array is None:
            raise RuntimeError("The MemmapArray has been closed; the file no longer exists")
        return self._array

    @property
    def filename(self) -> str:
        return self._filename

    @property
    def shape(self) -> tuple:
        return self._shape

    @property
    def dtype(self) -> np.dtype:
        return self._dtype

    # -- numpy protocol ---------------------------------------------------

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        arr = self.array
        if dtype is not None:
            arr = arr.astype(dtype, copy=False)
        if copy:
            arr = np.array(arr)
        return np.asarray(arr)

    def __getitem__(self, item):
        return self.array[item]

    def __setitem__(self, item, value):
        self.array[item] = value

    # -- lifecycle --------------------------------------------------------

    def __del__(self):
        try:
            if getattr(self, "_array", None) is not None:
                del self._array
            self._array = None
            if getattr(self, "_has_ownership", False) and os.path.isfile(self._filename):
                os.unlink(self._filename)
                self._has_ownership = False
        except Exception:
            pass
