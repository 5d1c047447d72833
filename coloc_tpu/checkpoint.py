"""Checkpoint / resume: serialize the session's persistent state.

Reference parity: SURVEY.md §5 — the reference persists scenes as PLY via
openMVG::sfm::Save but never loads anything back (a commented-out seed-map
path exists at coloc.hpp:80). This framework makes the map database the
checkpointable unit so a localization session can RESUME against a saved map:
  - MapDB (landmarks + descriptor bank + validity)
  - Scene (poses + observations) if present
  - Kalman filter bank state
  - frame counter / RNG key

Format: a single .npz (portable, no framework dependency); orbax is available
in the image but overkill for these sizes (<10 MB).
"""

from __future__ import annotations

import os
from typing import Optional

import jax.numpy as jnp
import numpy as np

from coloc_tpu.fusion import kalman
from coloc_tpu.sfm import reconstruct
from coloc_tpu.types import MapDB

_VERSION = 1


def save_session(path: str, session) -> None:
    """Snapshot a ColocSession's persistent state to `path` (.npz)."""
    data = {
        "version": _VERSION,
        "frame": session.frame,
        "map_ready": session.map_ready,
        "key": np.asarray(session.key),
        "fb_x": np.asarray(session.filter_bank.x),
        "fb_P": np.asarray(session.filter_bank.P),
        "fb_steps": np.asarray(session.filter_bank.steps),
    }
    if session.mapdb is not None:
        data.update(
            map_X=np.asarray(session.mapdb.X),
            map_desc=np.asarray(session.mapdb.desc),
            map_valid=np.asarray(session.mapdb.valid),
        )
        if session.lm_support is not None:
            # landmark-support bookkeeping (session.cull_map); optional keys
            # so older checkpoints load unchanged
            data.update(
                lm_support=np.asarray(session.lm_support),
                lm_last_seen=np.asarray(session.lm_last_seen),
            )
    if session.scene is not None:
        s = session.scene
        data.update(
            scene_Rs=np.asarray(s.Rs), scene_Cs=np.asarray(s.Cs),
            scene_X=np.asarray(s.X), scene_X_valid=np.asarray(s.X_valid),
            scene_obs=np.asarray(s.obs), scene_obs_mask=np.asarray(s.obs_mask),
            scene_desc=np.asarray(s.desc),
        )
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    # write through a file handle so the checkpoint lands EXACTLY at `path`
    # (np.savez appends ".npz" to bare string paths, which breaks a
    # save("x.ckpt") / load("x.ckpt") round trip)
    with open(path, "wb") as fh:
        np.savez_compressed(fh, **data)


def load_session(path: str, session) -> None:
    """Restore persistent state into an existing (configured) session."""
    z = np.load(path)
    assert int(z["version"]) <= _VERSION, f"unknown checkpoint version {z['version']}"
    session.frame = int(z["frame"])
    session.map_ready = bool(z["map_ready"])
    session.key = jnp.asarray(z["key"])
    session.filter_bank = kalman.FilterBank(
        x=jnp.asarray(z["fb_x"]),
        P=jnp.asarray(z["fb_P"]),
        steps=jnp.asarray(z["fb_steps"]),
    )
    if "map_X" in z:
        session.mapdb = MapDB(
            X=jnp.asarray(z["map_X"]),
            desc=jnp.asarray(z["map_desc"]),
            valid=jnp.asarray(z["map_valid"]),
        )
        if "lm_support" in z:
            session.lm_support = jnp.asarray(z["lm_support"])
            session.lm_last_seen = jnp.asarray(z["lm_last_seen"])
        else:
            # pre-support checkpoint: rebuild lazily at current frame
            session.lm_support = None
            session.lm_last_seen = None
    if "scene_Rs" in z:
        session.scene = reconstruct.Scene(
            Rs=jnp.asarray(z["scene_Rs"]), Cs=jnp.asarray(z["scene_Cs"]),
            X=jnp.asarray(z["scene_X"]),
            X_valid=jnp.asarray(z["scene_X_valid"]),
            obs=jnp.asarray(z["scene_obs"]),
            obs_mask=jnp.asarray(z["scene_obs_mask"]),
            desc=jnp.asarray(z["scene_desc"]),
        )


def save_mapdb(path: str, mapdb: MapDB) -> None:
    """Standalone map database export (exchangeable between sessions)."""
    with open(path, "wb") as fh:  # exact path (see save_session)
        np.savez_compressed(
            fh, version=_VERSION, X=np.asarray(mapdb.X),
            desc=np.asarray(mapdb.desc), valid=np.asarray(mapdb.valid),
        )


def load_mapdb(path: str) -> MapDB:
    z = np.load(path)
    return MapDB(
        X=jnp.asarray(z["X"]), desc=jnp.asarray(z["desc"]),
        valid=jnp.asarray(z["valid"]),
    )
