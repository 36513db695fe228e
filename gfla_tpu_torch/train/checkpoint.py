"""Checkpoints in the original GFLA's layout (counterpart of
gfla_tpu/train/checkpoint.py; the original's base_model.py:142-197).

Under {checkpoints_dir}/{name}/ each network goes to `{iter}_net_{G,D}.pth`
(numbered saves) and `latest_net_{G,D}.pth`, plain state dicts keyed like
the original's. The optimizer and scheduler states and the step go to a side
file, `{iter}_train_state.pth` / `latest_train_state.pth`, so that a resume
continues as gfla_tpu's full-state restore does; the text file `latest`
holds the step of the newest save. A directory whose files do not match the
networks (a stage-1 poseflownet run resumed by the pose task) loads
tolerantly, as gfla_tpu's restore does after its strict restore fails.
Every rank of a data-parallel run loads the same files, to the CPU and then
into its own device's tensors.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

import torch

from gfla_tpu_torch import parallel


def _dir(checkpoints_dir: str, name: str) -> str:
    return os.path.abspath(os.path.join(checkpoints_dir, name))


def _save(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)  # a reader never sees a half-written file


def save_checkpoint(checkpoints_dir: str, name: str, step: int,
                    nets: Dict[str, torch.nn.Module], train_state: Dict,
                    numbered: bool = True) -> str:
    """Write the `latest` files and, with `numbered`, the `{step}` files. In
    a data-parallel run every rank calls it: rank 0 writes (the replicas
    are equal), and all ranks leave once the files are on disk."""
    base = _dir(checkpoints_dir, name)
    if parallel.is_main():
        os.makedirs(base, exist_ok=True)
        tags = ["latest"] + ([str(step)] if numbered else [])
        for tag in tags:
            for net_name, net in nets.items():
                sd = {k: v.detach().cpu() for k, v in net.state_dict().items()}
                _save(sd, os.path.join(base, f"{tag}_net_{net_name}.pth"))
            _save(dict(train_state, step=step),
                  os.path.join(base, f"{tag}_train_state.pth"))
        with open(os.path.join(base, "latest"), "w") as f:
            f.write(str(step))
    parallel.barrier()
    return base


def get_iteration(checkpoints_dir: str, name: str,
                  which_iter: str = "latest") -> Optional[int]:
    """'latest' or a number -> the saved step, or None if nothing is saved
    (util.py:285-297 of the original)."""
    base = _dir(checkpoints_dir, name)
    if not os.path.isdir(base):
        return None
    if which_iter != "latest":
        return int(which_iter)
    latest = os.path.join(base, "latest")
    if os.path.exists(latest):
        with open(latest) as f:
            return int(f.read().strip())
    steps = [int(m.group(1)) for f in os.listdir(base)
             if (m := re.fullmatch(r"(\d+)_net_G\.pth", f))]
    return max(steps) if steps else None


def _load_state_dict(path: str) -> Optional[Dict]:
    if not os.path.exists(path):
        return None
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k.removeprefix("module."): v for k, v in sd.items()}


def _by_module(keys) -> str:
    """'source (40), target (96)': keys counted by their first component."""
    counts: Dict[str, int] = {}
    for key in keys:
        head = key.split(".", 1)[0]
        counts[head] = counts.get(head, 0) + 1
    return ", ".join(f"{head} ({n})" for head, n in counts.items()) or "none"


def load_checkpoint(checkpoints_dir: str, name: str,
                    nets: Dict[str, torch.nn.Module],
                    which_iter: str = "latest") -> Tuple[Optional[Dict],
                                                         Optional[int]]:
    """Load `{which_iter}_net_*.pth` into `nets` and return (train_state,
    step), or (None, None) when nothing is saved.

    As gfla_tpu's restore (train/checkpoint.py:80-110): when every net has a
    file holding exactly its keys, the load is strict and the train state
    comes back. Otherwise, as when the pose task resumes a directory that
    stage-1 poseflownet wrote (the two-stage protocol), each file that exists
    loads tolerantly (`partial_load`), what was loaded, skipped and left at
    its init is printed, and the train state is None: the caller keeps the
    step and starts fresh optimizers."""
    step = get_iteration(checkpoints_dir, name, which_iter)
    if step is None:
        return None, None
    base = _dir(checkpoints_dir, name)
    tag = which_iter if which_iter == "latest" else str(step)
    paths = {n: os.path.join(base, f"{tag}_net_{n}.pth") for n in nets}
    sds = {n: _load_state_dict(path) for n, path in paths.items()}
    if all(sds[n] is not None and sds[n].keys() == net.state_dict().keys()
           for n, net in nets.items()):
        for n, net in nets.items():
            net.load_state_dict(sds[n], strict=True)
        path = os.path.join(base, f"{tag}_train_state.pth")
        state = (torch.load(path, map_location="cpu", weights_only=True)
                 if os.path.exists(path) else None)
        return state, step
    print(f"{base} does not hold these networks as saved: loading what "
          f"matches, optimizers start fresh")
    for n, net in nets.items():
        if sds[n] is None:
            print(f"  {n}: no {os.path.basename(paths[n])}; left at its init")
            continue
        loaded, skipped = partial_load(net, sds[n])
        at_init = sorted(set(net.state_dict()) - set(loaded))
        print(f"  {n}: loaded {len(loaded)} tensors from "
              f"{os.path.basename(paths[n])}: {_by_module(loaded)}; skipped "
              f"{len(skipped)}: {skipped[:8]}; left at its init "
              f"{len(at_init)}: {_by_module(at_init)}")
    return None, step


def partial_load(module: torch.nn.Module, state_dict: Dict
                 ) -> Tuple[List[str], List[str]]:
    """Copy every entry of `state_dict` whose key and shape match into
    `module` (the original's tolerant load, base_model.py:167-192). Returns
    (loaded keys, skipped keys with the reason)."""
    own = module.state_dict()
    loaded, skipped, merged = [], [], {}
    for key, value in state_dict.items():
        key = key.removeprefix("module.")
        if key not in own:
            skipped.append(key)
        elif own[key].shape != value.shape:
            skipped.append(f"{key} (shape {tuple(value.shape)} vs "
                           f"{tuple(own[key].shape)})")
        else:
            merged[key] = value
            loaded.append(key)
    module.load_state_dict(merged, strict=False)
    return loaded, skipped
