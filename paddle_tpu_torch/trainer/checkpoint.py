"""Checkpoint save/load — the port's copy of the JAX package's layout
(paddle_tpu/trainer/checkpoint.py), so that a checkpoint either side writes
loads on the other.

A pass directory `pass-%05d` (or `pass-init` before the first pass
completed) holds `model.npz` and `trainer_config.json`.  The npz keys are
the nested state trees flattened with `|` and sorted dict keys:
`params|<name>`, `opt|slots|<name>|<slot>`, `opt|num_samples`,
`opt|num_updates`, `opt|pass_id` (0-d int32, as JAX writes them), under
gradient accumulation `opt|grad_accum|<name>`, `opt|grad_accum_count` and
`opt|grad_accum_samples`, under pruning `opt|masks|<name>`, `net|...`,
and `rng`, the trainer's threefry key (uint32 [2], as JAX writes it).  An
older port checkpoint's `dropout_rng` (a torch generator's state) is
loaded but read by nothing.  The write is staged under
`<dir>.tmp` and committed with one rename; an existing pass is moved aside
first and dropped only after the commit.
"""

from __future__ import annotations

import os
import re
import shutil
import zipfile
from typing import Any, Optional

import numpy as np
import torch

SEP = "|"   # path separator inside npz keys


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    if isinstance(leaf, (bool, int)):          # host counters: int32 as JAX
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def _flatten(tree: Any, prefix: str) -> dict[str, np.ndarray]:
    """Nested dicts -> {prefix|k1|k2...: array}, keys in sorted order at
    every level (jax.tree_util's dict order)."""
    flat: dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            flat.update(_flatten(tree[k], prefix + SEP + str(k)))
    else:
        flat[prefix] = _to_numpy(tree)
    return flat


def _unflatten_dicts(flat: dict[str, np.ndarray]) -> dict:
    """Rebuild nested dicts from SEP-joined keys, inserted in sorted key
    order whatever the writer's order."""
    root: dict = {}
    for key in sorted(flat):
        parts = key.split(SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = flat[key]
    return root


def _fsync_dir(path: str) -> None:
    """Best-effort directory fsync; a filesystem that cannot fsync a
    directory is no reason to fail the save."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def pass_dir(save_dir: str, pass_id: int) -> str:
    """pass_id < 0 is a snapshot taken before the first pass completed."""
    if pass_id < 0:
        return os.path.join(save_dir, "pass-init")
    return os.path.join(save_dir, f"pass-{pass_id:05d}")


def save_checkpoint(save_dir: str, pass_id: int, params: dict,
                    opt_state: Optional[dict] = None,
                    net_state: Optional[dict] = None,
                    config_json: Optional[str] = None, keep_last: int = 0,
                    rng: Optional[np.ndarray] = None) -> str:
    """Write pass-%05d/{model.npz, trainer_config.json} atomically; returns
    the pass directory."""
    d = pass_dir(save_dir, pass_id)
    tmp_d = d + ".tmp"
    if os.path.isdir(tmp_d):
        shutil.rmtree(tmp_d)                 # stale straggler from a crash
    os.makedirs(tmp_d)
    flat = _flatten(params, "params")
    if opt_state is not None:
        flat.update(_flatten(opt_state, "opt"))
    if net_state:
        flat.update(_flatten(net_state, "net"))
    if rng is not None:
        flat["rng"] = np.asarray(rng)
    tmp_npz = os.path.join(tmp_d, "model.npz.part")
    with open(tmp_npz, "wb") as f:
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp_npz, os.path.join(tmp_d, "model.npz"))
    if config_json is not None:
        with open(os.path.join(tmp_d, "trainer_config.json"), "w") as f:
            f.write(config_json)
            f.flush()
            os.fsync(f.fileno())
    old_d = d + ".old.tmp"
    if os.path.isdir(old_d):
        shutil.rmtree(old_d)
    if os.path.isdir(d):
        os.replace(d, old_d)                 # aside, not deleted pre-commit
    _fsync_dir(tmp_d)
    os.replace(tmp_d, d)                     # the commit point
    _fsync_dir(save_dir)
    shutil.rmtree(old_d, ignore_errors=True)
    if keep_last > 0:
        _delete_old(save_dir, keep_last)
    return d


def _delete_old(save_dir: str, keep_last: int) -> None:
    """Keep the newest `keep_last` committed passes (pass-init counts as
    the oldest); sweep crashed-save stragglers."""
    for x in os.listdir(save_dir):
        if re.match(r"pass-(\d{5}|init)(\.old)?\.tmp$", x):
            shutil.rmtree(os.path.join(save_dir, x), ignore_errors=True)
    dirs = sorted(x for x in os.listdir(save_dir)
                  if re.match(r"pass-\d{5}$", x))
    if os.path.isdir(os.path.join(save_dir, "pass-init")):
        dirs.insert(0, "pass-init")
    for old in dirs[:-keep_last]:
        shutil.rmtree(os.path.join(save_dir, old), ignore_errors=True)


def latest_pass(save_dir: str) -> int:
    """Highest committed pass id under save_dir, or -1."""
    if not os.path.isdir(save_dir):
        return -1
    ids = [int(m.group(1)) for m in
           (re.match(r"pass-(\d{5})$", x) for x in os.listdir(save_dir)) if m]
    return max(ids, default=-1)


def latest_checkpoint(save_dir: str) -> Optional[str]:
    """Path of the newest committed pass dir under `save_dir` (falling
    back to `pass-init`), or None; `.tmp` stragglers of a crashed save
    never match (tools/serve.py --checkpoint uses it)."""
    lp = latest_pass(save_dir)
    if lp >= 0:
        return pass_dir(save_dir, lp)
    init = os.path.join(save_dir, "pass-init")
    return init if os.path.isdir(init) else None


def load_checkpoint(path: str) -> dict[str, Any]:
    """Load a pass directory, its model.npz, or a save_dir (its newest
    committed pass, else pass-init).  Returns {'params', 'opt', 'net'} as
    nested dicts of numpy arrays, plus 'rng', 'dropout_rng', 'pass_id' and
    'config_json' where present."""
    if path.endswith(".npz"):
        npz = path
    else:
        npz = os.path.join(path, "model.npz")
        if not os.path.exists(npz):
            lp = latest_pass(path)
            cand = pass_dir(path, lp if lp >= 0 else -1)
            npz = os.path.join(cand, "model.npz")
    try:
        with np.load(npz, allow_pickle=False) as data:
            flat = {k: data[k] for k in data.files}
    except (zipfile.BadZipFile, EOFError, ValueError) as e:
        raise ValueError(f"checkpoint {npz} is corrupt or truncated ({e}); "
                         f"delete its pass directory and resume from the "
                         f"newest committed one") from e
    out: dict[str, Any] = {}
    for prefix in ("params", "opt", "net"):
        sub = {k[len(prefix) + 1:]: v for k, v in flat.items()
               if k.startswith(prefix + SEP)}
        out[prefix] = _unflatten_dicts(sub)
    for key in ("rng", "dropout_rng"):
        if key in flat:
            out[key] = flat[key]
    base = os.path.basename(os.path.dirname(os.path.abspath(npz)))
    m = re.match(r"pass-(\d{5})$", base)
    if m:
        out["pass_id"] = int(m.group(1))
    elif base == "pass-init":
        out["pass_id"] = -1
    cfg_path = os.path.join(os.path.dirname(npz), "trainer_config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            out["config_json"] = f.read()
    return out
