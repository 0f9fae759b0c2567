"""Exact-state checkpoint / resume (port of vampomi_tpu/engine/checkpoint.py).

One `.npz` holds every array and scalar needed to continue a trajectory
exactly: the M- and N-vectors of the engine's state in f64, its f64 scalars,
the (masked) prior, and the state of the run's CPU torch.Generator.  The
keys are the JAX package's:

    __version__, __iteration__       format version, last finished iteration
    prior_probs, prior_vars, prior_active
    arr_<name>, scl_<name>, meta_<name>

Format versions:

  * 2, this package's: the generator's `get_state()` bytes under
    `rng_state` (uint8).
  * 1, the JAX package's: a JAX PRNG key under `rng_key`, which a torch
    generator cannot replay.  It is read (`load_checkpoint`), never written
    here; `convert.checkpoint_from_jax` decides where such a file may resume.

Writes are atomic: a per-pid tmp file, flushed and fsynced, then renamed over
the target, so a killed run never leaves a torn file.  Of the ranks of a
sharded run only rank 0 saves; its file holds the full Mt vectors, so a
checkpoint resumes on any number of ranks.
"""

from __future__ import annotations

import os

import numpy as np

from ..sharding import is_writer

FORMAT_VERSION = 2
JAX_FORMAT_VERSION = 1


def atomic_savez(path: str, **payload) -> None:
    """np.savez to `path` through a per-pid tmp file (flush, fsync, rename):
    two writers sharing a path never truncate each other's file, and a
    reader sees the old file or the new one, never half of one."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:  # an open handle: savez must not append .npz
        np.savez(f, **payload)
        f.flush()
        os.fsync(f.fileno())  # the data is durable before the rename
    os.replace(tmp, path)


def save_checkpoint(path: str, *, iteration: int, arrays: dict, scalars: dict,
                    prior: dict, rng_state, meta: dict | None = None) -> None:
    """Write the checkpoint atomically, on rank 0 alone (every rank holds
    the same replicated state; several writers would tear the file).
    `prior` holds host arrays `probs`, `vars`, `active`; `rng_state` is
    `torch.Generator.get_state()` (or its bytes)."""
    if not is_writer():
        return
    payload = {
        "__version__": np.asarray(FORMAT_VERSION),
        "__iteration__": np.asarray(iteration),
        "prior_probs": np.asarray(prior["probs"], dtype=np.float64),
        "prior_vars": np.asarray(prior["vars"], dtype=np.float64),
        "prior_active": np.asarray(prior["active"], dtype=bool),
        "rng_state": np.asarray(rng_state, dtype=np.uint8),
    }
    for k, v in arrays.items():
        payload["arr_" + k] = np.asarray(v)
    for k, v in scalars.items():
        payload["scl_" + k] = np.asarray(float(v))
    for k, v in (meta or {}).items():
        payload["meta_" + k] = np.asarray(v)
    atomic_savez(path, **payload)


def load_checkpoint(path: str) -> dict:
    """The checkpoint's contents: version, iteration, prior, arrays, scalars,
    meta, and `rng_state` (version 2) or `rng_key` (the JAX package's
    version 1).  Any other version raises."""
    with np.load(path, allow_pickle=False) as z:
        version = int(z["__version__"])
        if version not in (FORMAT_VERSION, JAX_FORMAT_VERSION):
            raise ValueError(
                f"checkpoint {path}: format version {version}, not {FORMAT_VERSION} "
                f"(this package's) or {JAX_FORMAT_VERSION} (the JAX package's)")
        out = {
            "version": version,
            "iteration": int(z["__iteration__"]),
            "prior": dict(probs=z["prior_probs"], vars=z["prior_vars"],
                          active=z["prior_active"]),
            "rng_state": z["rng_state"] if "rng_state" in z.files else None,
            "rng_key": z["rng_key"] if "rng_key" in z.files else None,
            "arrays": {},
            "scalars": {},
            "meta": {},
        }
        for k in z.files:
            if k.startswith("arr_"):
                out["arrays"][k[4:]] = z[k]
            elif k.startswith("scl_"):
                out["scalars"][k[4:]] = float(z[k])
            elif k.startswith("meta_"):
                out["meta"][k[5:]] = z[k]
    return out


def check_meta(ck: dict, **expected) -> None:
    """Fail fast on a mismatched resume (another dataset shape or model)
    instead of a shape error or a silently wrong trajectory."""
    for k, v in expected.items():
        got = ck.get("meta", {}).get(k)
        if got is None:
            continue  # a checkpoint without this field: best effort
        got = got.item() if hasattr(got, "item") else got
        if str(got) != str(v):
            raise ValueError(
                f"checkpoint {k}={got!r} does not match this run's {k}={v!r}")


def load_resume(path: str, *, model: str, solver: str, **meta) -> dict:
    """The checkpoint of `--resume-file`, checked against this run: its meta
    (model, shapes) must match, and a JAX-written file must be one the
    port can continue under `solver` (convert.checkpoint_from_jax, which
    cuts a padded mesh run's vectors to Mt first)."""
    ck = load_checkpoint(path)
    if ck["version"] == JAX_FORMAT_VERSION:
        from ..convert import checkpoint_from_jax

        ck = checkpoint_from_jax(ck, model=model, solver=solver)
    check_meta(ck, model=model, **meta)
    return ck
