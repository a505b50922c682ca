"""Storage backends (the port's copy of ``tmae_tpu/utils/file_client.py``):
the datasets read through a ``FileClient``, whose only backend is the local
disk; another store plugs in with ``register_backend``."""

from __future__ import annotations

import json
import pickle
from abc import ABC, abstractmethod
from contextlib import contextmanager
from pathlib import Path

import numpy as np


class BaseStorageBackend(ABC):
    """get() → bytes; get_text() → str."""

    @property
    def name(self):
        return self.__class__.__name__

    @abstractmethod
    def get(self, filepath) -> bytes:
        ...

    @abstractmethod
    def get_text(self, filepath, encoding='utf-8') -> str:
        ...


class HardDiskBackend(BaseStorageBackend):
    """Plain filesystem backend."""

    def get(self, filepath) -> bytes:
        return Path(filepath).read_bytes()

    def get_text(self, filepath, encoding='utf-8') -> str:
        return Path(filepath).read_text(encoding=encoding)

    def put(self, obj: bytes, filepath):
        p = Path(filepath)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(obj)

    def exists(self, filepath) -> bool:
        return Path(filepath).exists()

    @contextmanager
    def get_local_path(self, filepath):
        yield str(filepath)


_BACKENDS = {'disk': HardDiskBackend}


def register_backend(name, cls):
    _BACKENDS[name] = cls


class FileClient:
    """Dispatching wrapper and typed loaders."""

    def __init__(self, backend='disk', **kwargs):
        if backend not in _BACKENDS:
            raise KeyError(
                f'unknown storage backend {backend}; have {list(_BACKENDS)}')
        self.backend = _BACKENDS[backend](**kwargs)

    def get(self, filepath) -> bytes:
        return self.backend.get(filepath)

    def get_text(self, filepath, encoding='utf-8') -> str:
        return self.backend.get_text(filepath, encoding)

    def put(self, obj: bytes, filepath):
        return self.backend.put(obj, filepath)

    def exists(self, filepath) -> bool:
        return self.backend.exists(filepath)

    def get_local_path(self, filepath):
        return self.backend.get_local_path(filepath)

    def load_pickle(self, filepath):
        return pickle.loads(self.get(filepath))

    def load_json(self, filepath):
        return json.loads(self.get_text(filepath))

    def load_npy(self, filepath):
        import io

        return np.load(io.BytesIO(self.get(filepath)), allow_pickle=False)

    def load_to_numpy(self, filepath, dtype=np.float32):
        """Raw binary → 1-D array (the ONCE ``.bin`` lidar layout)."""
        return np.frombuffer(self.get(filepath), dtype=dtype)
