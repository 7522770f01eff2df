"""dtown_torch map compiler, config and kernel tables vs the JAX package."""
import dataclasses

import numpy as np
import pytest
import torch

from dtown import map_loader as jmap_loader
from dtown import types as jtypes
from dtown.ops import state_kernel as jsk

from dtown_torch import EnvConfig, load_map
from dtown_torch.convert import maps_from_numpy
from dtown_torch.ops import state_kernel as sk
from dtown_torch.types import MAP_FIELDS


def test_env_config_matches_reference():
    ours = {f.name: f.default for f in dataclasses.fields(EnvConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(jtypes.EnvConfig)}
    assert ours == ref
    assert EnvConfig().delta_time == jtypes.EnvConfig().delta_time


def test_map_fields_match_reference():
    ref = [f.name for f in dataclasses.fields(jtypes.MapArrays)]
    assert list(MAP_FIELDS) == ref


@pytest.mark.parametrize("map_name", jmap_loader.list_maps())
def test_load_map_matches_reference(map_name):
    ours = load_map(map_name)
    ref = jmap_loader.load_map(map_name)
    for f in MAP_FIELDS:
        a = np.asarray(getattr(ours, f))
        b = np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_maps_from_numpy_roundtrip():
    ref = jmap_loader.load_map("small_loop")
    m = maps_from_numpy({f: np.asarray(getattr(ref, f)) for f in MAP_FIELDS})
    assert m.grid_shape == ref.grid_shape
    np.testing.assert_array_equal(m.spawn_pos, np.asarray(ref.spawn_pos))
    t = m.to("cpu")
    assert t.curves.dtype == torch.float32 and t.drivable.dtype == torch.bool
    np.testing.assert_array_equal(t.tile_kind.numpy(), m.tile_kind)
    with pytest.raises(ValueError):
        maps_from_numpy({"tile_kind": m.tile_kind})


@pytest.mark.parametrize("map_name", ["loop_obstacles", "small_loop",
                                      "udem1"])
def test_build_tables_matches_reference(map_name):
    ours = sk.build_tables(EnvConfig(), load_map(map_name))
    ref = jsk.build_tables(jtypes.EnvConfig(), jmap_loader.load_map(map_name))
    for k in ("ct", "words", "ot", "bank"):
        np.testing.assert_array_equal(ours[k], np.asarray(ref[k]),
                                      err_msg=k)
    for k in ("n_ok", "n_words", "M", "Hg", "Wg", "ts_inv", "moving_cols",
              "opt_cols"):
        assert ours[k] == ref[k], k
    assert len(ours["npcs"]) == len(ref["npcs"])
