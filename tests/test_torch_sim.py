"""The port's graph simulators (Python and native C++) against the JAX
package's Python simulator, on one seeded world: states and navigable
locations over a random action sequence (the same 1e-9 / 1e-6 tolerances as
tests/test_sim_native.py), the 36-view sweep, turns, ``make_action_at``,
``make_simulator``'s engine choice, the native build into
visitron_torch/_build/, the closed-form datagen walk against driving the
simulator (tests/test_pretrain_pipeline.py:46), and the helpers the
environment needs (``NavGraph.next_on_path``, ``candidate_angle_features``)."""

import math
import shutil

import numpy as np
import pytest

from visitron_torch import geometry as geo
from visitron_torch.data.candidates import build_candidate_tables, candidate_angle_features
from visitron_torch.pipelines.pretrain_datagen import walk_path_examples
from visitron_torch.sim import GraphSimulator, make_simulator
from visitron_torch.testing import SyntheticWorld as TWorld
from visitron_tpu.data.candidates import build_candidate_tables as j_tables
from visitron_tpu.data.candidates import candidate_angle_features as j_angle_features
from visitron_tpu.sim import make_simulator as j_make_simulator
from visitron_tpu.testing import SyntheticWorld as JWorld

WORLD = dict(seed=7, num_scans=2, viewpoints_per_scan=24, scene_feat_dim=64)
ENGINES = ["python", "native"]


@pytest.fixture(scope="module")
def worlds():
    return JWorld(**WORLD), TWorld(**WORLD)


def _native_or_skip():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native engine cannot be built")


def _port_sim(tw, engine, batch_size=3):
    if engine == "native":
        _native_or_skip()
        from visitron_torch.sim.native import NativeGraphSimulator

        sim = NativeGraphSimulator(tw.graphs)
        sim.set_batch_size(batch_size)
        sim.set_camera_resolution(640, 480)
        sim.set_camera_vfov(math.radians(60))
        sim.initialize()
        return sim
    return make_simulator(tw.graphs, batch_size=batch_size, prefer_native=False)


def _assert_states_equal(a, b):
    assert a.scanId == b.scanId
    assert a.location.viewpointId == b.location.viewpointId
    assert a.location.ix == b.location.ix
    assert a.viewIndex == b.viewIndex and a.step == b.step
    assert abs(a.heading - b.heading) < 1e-9 and abs(a.elevation - b.elevation) < 1e-9
    assert [loc.viewpointId for loc in a.navigableLocations] == [
        loc.viewpointId for loc in b.navigableLocations]
    for la, lb in zip(a.navigableLocations, b.navigableLocations):
        for k in ("rel_heading", "rel_elevation", "rel_distance", "x", "y", "z"):
            assert abs(getattr(la, k) - getattr(lb, k)) < 1e-6, k


@pytest.mark.parametrize("engine", ENGINES)
def test_random_walk_matches_jax(worlds, engine):
    """120 steps of random moves and turns from random starts: every state
    equals the JAX simulator's."""
    jw, tw = worlds
    jsim = j_make_simulator(jw.graphs, batch_size=3, prefer_native=False)
    tsim = _port_sim(tw, engine)
    rng = np.random.default_rng(0)
    scans = [tw.scans[i % len(tw.scans)] for i in range(3)]
    vps = [tw.graphs[s].viewpoints[int(rng.integers(5))] for s in scans]
    headings = rng.uniform(0, 2 * np.pi, 3).tolist()
    jsim.new_episode(scans, vps, headings, [0.0] * 3)
    tsim.new_episode(scans, vps, headings, [0.0] * 3)
    moved = 0
    for _ in range(120):
        ja, ta = jsim.get_states(), tsim.get_states()
        for a, b in zip(ta, ja):
            _assert_states_equal(a, b)
        ix, dh, de = [], [], []
        for s in ja:
            n = len(s.navigableLocations)
            move = rng.random() < 0.4 and n > 1
            ix.append(int(rng.integers(1, n)) if move else 0)
            moved += move
            dh.append(float(rng.integers(-1, 2)))
            de.append(float(rng.integers(-1, 2)))
        jsim.make_action(ix, dh, de)
        tsim.make_action(ix, dh, de)
    for a, b in zip(tsim.get_states(), jsim.get_states()):
        _assert_states_equal(a, b)
    assert moved > 20


@pytest.mark.parametrize("engine", ENGINES)
def test_make_action_at_steps_one_item(worlds, engine):
    jw, tw = worlds
    jsim = j_make_simulator(jw.graphs, batch_size=3, prefer_native=False)
    tsim = _port_sim(tw, engine)
    scans = [tw.scans[0]] * 3
    vps = [tw.graphs[scans[0]].viewpoints[0]] * 3
    for sim in (jsim, tsim):
        sim.new_episode(scans, vps, [0.0] * 3, [0.0] * 3)
        sim.make_action_at(1, 0, 1.0, 0.0)
    for a, b in zip(tsim.get_states(), jsim.get_states()):
        _assert_states_equal(a, b)
    assert [s.step for s in tsim.get_states()] == [0, 1, 0]


@pytest.mark.parametrize("engine", ENGINES)
def test_view_sweep_and_turn_limits(worlds, engine):
    """The reference candidate sweep visits viewIndex 0..35 in order; the
    heading wraps and the elevation clamps at the top row."""
    _, tw = worlds
    sim = _port_sim(tw, engine)
    scans = [tw.scans[i % 2] for i in range(3)]
    vps = [tw.graphs[s].viewpoints[0] for s in scans]
    sim.new_episode(scans, vps, [0.0] * 3, [math.radians(-30)] * 3)
    for ix in range(36):
        if ix:
            sim.make_action([0] * 3, [1.0] * 3, [1.0 if ix % 12 == 0 else 0.0] * 3)
        for st in sim.get_states():
            assert st.viewIndex == ix
            assert abs(st.heading - geo.heading_of_view(ix)) < 1e-9
            assert abs(st.elevation - geo.elevation_of_view(ix)) < 1e-9
    sim.new_episode(scans, vps, [0.0] * 3, [0.0] * 3)
    for _ in range(12):
        sim.make_action([0] * 3, [-1.0] * 3, [1.0] * 3)
    st = sim.get_states()[0]
    assert st.viewIndex % 12 == 0 and st.viewIndex // 12 == 2 and st.step == 12


def test_make_simulator_prefers_native(worlds):
    """Where g++ exists the native engine is the one taken; prefer_native
    False gives the Python engine."""
    _native_or_skip()
    from visitron_torch.sim.native import NativeGraphSimulator

    _, tw = worlds
    sim = make_simulator(tw.graphs, batch_size=2, prefer_native=True)
    assert isinstance(sim, NativeGraphSimulator)
    sim.new_episode([tw.scans[0]] * 2, [tw.graphs[tw.scans[0]].viewpoints[0]] * 2,
                    [0.0, 1.0], [0.0, 0.0])
    assert sim.get_states()[0].viewIndex == 12  # heading 0, elevation row 1
    assert isinstance(make_simulator(tw.graphs, prefer_native=False), GraphSimulator)


def test_native_library_builds_from_the_port_source_into_build_dir():
    _native_or_skip()
    from pathlib import Path

    import visitron_torch
    from visitron_torch.sim import native

    pkg = Path(visitron_torch.__file__).resolve().parent
    lib = Path(native.build_library())
    assert lib.parent == pkg / "_build" and lib.name.startswith("libgraph_sim-")
    assert native._SRC == pkg / "sim" / "csrc" / "graph_sim.cpp"
    assert not list((pkg / "sim" / "csrc").glob("*.so"))
    assert native.build_library() == str(lib)  # cached: the same library


def test_python_simulator_refuses_misuse(worlds):
    _, tw = worlds
    sim = GraphSimulator(tw.graphs)
    with pytest.raises(RuntimeError, match="initialize"):
        sim.new_episode([tw.scans[0]], [tw.graphs[tw.scans[0]].viewpoints[0]], [0.0])
    sim.initialize()
    with pytest.raises(ValueError, match="batch"):
        sim.new_episode([tw.scans[0]] * 2, [tw.graphs[tw.scans[0]].viewpoints[0]] * 2,
                        [0.0] * 2)
    with pytest.raises(NotImplementedError):
        sim.set_rendering_enabled(True)


@pytest.mark.parametrize("engine", ENGINES)
def test_datagen_walk_matches_driving_the_simulator(worlds, engine):
    """The closed-form pretraining walk agrees with driving the simulator
    through goToNextViewpoint (generate_pretraining_data.py:152-186)."""
    _, tw = worlds
    sim = _port_sim(tw, engine, batch_size=1)
    tables = build_candidate_tables(tw.graphs, geo.camera_hfov(640, 480, math.radians(60)))
    g = tw.graphs[tw.scans[0]]
    rng = np.random.default_rng(0)
    walked = 0
    for _ in range(8):
        u, v = rng.integers(g.num_viewpoints, size=2)
        if u == v:
            continue
        path = g.shortest_path(int(u), int(v))
        heading = float(rng.uniform(0, 2 * np.pi))
        steps = walk_path_examples(g, tables[g.scan], path, heading, 0.0)
        sim.new_episode([g.scan], [path[0]], [heading], [0.0])
        for i, step in enumerate(steps):
            state = sim.get_states()[0]
            assert state.location.viewpointId == path[i]
            assert state.viewIndex == step["current_view_index"], (i, path)
            trg = step["target_abs_view_index"]
            level, trg_level = state.viewIndex // 12, trg // 12
            while level < trg_level:
                sim.make_action([0], [0.0], [1.0])
                level += 1
            while level > trg_level:
                sim.make_action([0], [0.0], [-1.0])
                level -= 1
            while sim.get_states()[0].viewIndex != trg:
                sim.make_action([0], [1.0], [0.0])
            nav = [loc.viewpointId for loc in sim.get_states()[0].navigableLocations]
            sim.make_action([nav.index(path[i + 1])], [0.0], [0.0])
        assert sim.get_states()[0].location.viewpointId == path[-1]
        walked += 1
    assert walked >= 5


def test_next_on_path_and_candidate_angle_features_match_jax(worlds):
    jw, tw = worlds
    hfov = geo.camera_hfov(640, 480, math.radians(60))
    jt, tt = j_tables(jw.graphs, hfov), build_candidate_tables(tw.graphs, hfov)
    rng = np.random.default_rng(3)
    for scan in tw.scans:
        jg, tg = jw.graphs[scan], tw.graphs[scan]
        for u in range(tg.num_viewpoints):
            for v in range(tg.num_viewpoints):
                assert tg.next_on_path(u, v) == jg.next_on_path(u, v)
        assert tg.next_on_path(tg.viewpoints[3], tg.viewpoints[3]) == tg.viewpoints[3]
        vp = rng.integers(tg.num_viewpoints, size=16)
        views = rng.integers(36, size=16)
        np.testing.assert_array_equal(candidate_angle_features(tt[scan], vp, views),
                                      j_angle_features(jt[scan], vp, views))
