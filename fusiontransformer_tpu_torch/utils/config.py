"""Minimal yacs-compatible configuration node.

The reference uses ``yacs.config.CfgNode`` (see reference
``FusionTransformer/common/config/base.py:5`` and ``train.py:54-59``).  yacs is
not available in this environment, so this module provides a drop-in subset
with identical user-facing semantics:

* attribute + mapping access (``cfg.MODEL.TYPE`` / ``cfg["MODEL"]["TYPE"]``)
* ``merge_from_file`` (YAML) and ``merge_from_list`` (``KEY.SUBKEY value`` pairs)
* string literal decoding (``"(\"train\",)"`` -> tuple, ``"None"`` -> None)
* ``freeze()`` / ``defrost()`` with mutation guard
* ``clone()`` and pretty ``__str__``
* ``purge_cfg`` (reference ``common/config/__init__.py:4-17``): prunes sibling
  CfgNode children whose key differs from the active ``TYPE`` value.
"""

from __future__ import annotations

import ast
import copy
from typing import Any

import yaml

_FROZEN = "__frozen__"


class CfgNode(dict):
    """A dict with attribute access, freezing, and YAML/list merging."""

    def __init__(self, init_dict=None):
        init_dict = {} if init_dict is None else init_dict
        super().__init__()
        object.__setattr__(self, _FROZEN, False)
        for k, v in dict(init_dict).items():
            self[k] = CfgNode(v) if _is_plain_dict(v) else v

    # -- attribute access -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __setitem__(self, name, value):
        if self.is_frozen():
            raise AttributeError(
                f"Attempted to set {name} to {value}, but CfgNode is frozen"
            )
        super().__setitem__(name, value)

    def __delattr__(self, name):
        del self[name]

    # -- freezing ----------------------------------------------------------
    def freeze(self):
        self._set_frozen(True)

    def defrost(self):
        self._set_frozen(False)

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, _FROZEN)

    def _set_frozen(self, flag: bool):
        object.__setattr__(self, _FROZEN, flag)
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_frozen(flag)

    # -- merging -----------------------------------------------------------
    def clone(self) -> "CfgNode":
        """Deep copy; the clone is returned defrosted (mutable)."""
        return CfgNode(copy.deepcopy(_to_plain_dict(self)))

    def merge_from_file(self, cfg_filename: str):
        with open(cfg_filename, "r") as f:
            loaded = yaml.safe_load(f)
        if loaded is None:
            return
        _merge_a_into_b(CfgNode(loaded), self, key_path=[])

    def merge_from_other_cfg(self, cfg_other: "CfgNode"):
        _merge_a_into_b(cfg_other, self, key_path=[])

    def merge_from_list(self, cfg_list):
        assert len(cfg_list) % 2 == 0, (
            f"Override list has odd length: {cfg_list}"
        )
        for full_key, v in zip(cfg_list[0::2], cfg_list[1::2]):
            if full_key.startswith("--"):
                raise ValueError(
                    f"Flag {full_key!r} found among KEY VALUE overrides — "
                    "place flags like --ckpt BEFORE the dotted overrides")
            keys = full_key.split(".")
            d = self
            for sub in keys[:-1]:
                assert sub in d, f"Non-existent key: {full_key}"
                d = d[sub]
            sub = keys[-1]
            assert sub in d, f"Non-existent key: {full_key}"
            value = _decode_value(v)
            d[sub] = _coerce_value_type(value, d[sub], full_key)

    # -- misc ----------------------------------------------------------------
    def dump(self) -> str:
        return yaml.safe_dump(_to_plain_dict(self))

    def __str__(self) -> str:
        def _render(node, indent):
            lines = []
            for k in sorted(node.keys()):
                v = node[k]
                if isinstance(v, CfgNode):
                    lines.append(" " * indent + f"{k}:")
                    lines.extend(_render(v, indent + 2))
                else:
                    lines.append(" " * indent + f"{k}: {v}")
            return lines

        return "\n".join(_render(self, 0))

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}({super().__repr__()})"

    def __reduce__(self):
        # Pickled as its plain dict and frozen flag (a config sent to
        # another process): dict's own pickling would set items before the
        # flag exists.
        return _unpickle_cfg, (_to_plain_dict(self), self.is_frozen())


def _unpickle_cfg(plain, frozen):
    cfg = CfgNode(plain)
    if frozen:
        cfg.freeze()
    return cfg


# Alias matching yacs import style used across the reference.
CN = CfgNode


def _is_plain_dict(v) -> bool:
    return isinstance(v, dict) and not isinstance(v, CfgNode) or isinstance(v, CfgNode)


def _to_plain_dict(node: CfgNode) -> dict:
    out = {}
    for k, v in node.items():
        out[k] = _to_plain_dict(v) if isinstance(v, CfgNode) else v
    return out


def _decode_value(v: Any) -> Any:
    """Decode str values into python literals when possible (yacs behavior)."""
    if not isinstance(v, str):
        return v
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def _coerce_value_type(replacement, original, full_key):
    """Allow tuple<->list coercion and None anywhere (lenient vs yacs)."""
    if original is None or replacement is None:
        return replacement
    rt, ot = type(replacement), type(original)
    if rt == ot:
        return replacement
    if isinstance(replacement, (tuple, list)) and isinstance(original, (tuple, list)):
        return ot(replacement)
    if isinstance(replacement, (int, float)) and isinstance(original, (int, float)):
        return ot(replacement)
    raise ValueError(
        f"Type mismatch ({ot} vs {rt}) for key {full_key}: "
        f"{original} vs {replacement}"
    )


def _merge_a_into_b(a: CfgNode, b: CfgNode, key_path):
    for k, v_raw in a.items():
        full_key = ".".join(key_path + [k])
        v = _decode_value(v_raw)
        if k not in b:
            raise KeyError(f"Non-existent config key: {full_key}")
        if isinstance(v, CfgNode) and isinstance(b[k], CfgNode):
            _merge_a_into_b(v, b[k], key_path + [k])
        else:
            b[k] = _coerce_value_type(v, b[k], full_key)


def purge_cfg(cfg: CfgNode):
    """Remove sibling CfgNode children whose key is not the active TYPE.

    Mirrors reference ``common/config/__init__.py:4-17``: when a node carries a
    ``TYPE`` attribute, its CfgNode children keyed differently from the TYPE
    value are deleted so the logged config only shows the active block.
    """
    target_key = cfg.get("TYPE", None)
    removed = []
    for k, v in cfg.items():
        if isinstance(v, CfgNode):
            if target_key is not None and k != target_key:
                removed.append(k)
            else:
                purge_cfg(v)
    for k in removed:
        del cfg[k]
