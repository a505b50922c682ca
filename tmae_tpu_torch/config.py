"""Config system: YAML with single-level ``_BASE_CONFIG_`` inheritance (the
port's copy of ``tmae_tpu/config.py``; it reads the same files under
``tools/cfgs/``). Configs are nested ``Cfg`` dicts with attribute access,
created per entry point.
"""

from __future__ import annotations

import copy
from pathlib import Path

import yaml


class Cfg(dict):
    """Nested dict with attribute access. ``cfg.MODEL.NAME`` == ``cfg['MODEL']['NAME']``."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def get(self, key, default=None):
        return super().get(key, default)

    @classmethod
    def from_dict(cls, d):
        if isinstance(d, dict):
            return cls({k: cls.from_dict(v) for k, v in d.items()})
        if isinstance(d, (list, tuple)):
            return type(d)(cls.from_dict(v) for v in d)
        return d


def _merge_new_config(config: dict, new_config: dict, base_dir: Path) -> dict:
    """Recursive merge; ``_BASE_CONFIG_`` is loaded first then overlaid (reference
    semantics: ``pcdet/config.py:51-68``)."""
    if '_BASE_CONFIG_' in new_config:
        base_path = Path(new_config['_BASE_CONFIG_'])
        if not base_path.is_absolute():
            # resolve relative to the repo's tools/ dir (reference convention
            # 'cfgs/dataset_configs/...'), falling back to the including file's dir.
            candidates = [base_dir / base_path, _TOOLS_DIR / base_path]
            for cand in candidates:
                if cand.exists():
                    base_path = cand
                    break
        with open(base_path) as f:
            base_cfg = yaml.safe_load(f)
        _merge_new_config(config, base_cfg, base_path.parent)
    for key, val in new_config.items():
        if key == '_BASE_CONFIG_':
            continue
        if isinstance(val, dict):
            if not isinstance(config.get(key), dict):
                config[key] = {}
            _merge_new_config(config[key], val, base_dir)
        else:
            config[key] = copy.deepcopy(val)
    return config


_TOOLS_DIR = Path(__file__).resolve().parent.parent / 'tools'


def cfg_from_yaml_file(cfg_file) -> Cfg:
    cfg_file = Path(cfg_file)
    with open(cfg_file) as f:
        new_config = yaml.safe_load(f)
    config: dict = {}
    _merge_new_config(config, new_config, cfg_file.parent)
    cfg = Cfg.from_dict(config)
    cfg.TAG = cfg_file.stem
    # EXP_GROUP_PATH, e.g. 'once_models' for tools/cfgs/once_models/t_mae.yaml
    parts = cfg_file.resolve().parts
    cfg.EXP_GROUP_PATH = parts[-2] if len(parts) >= 2 else ''
    return cfg
