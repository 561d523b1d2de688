"""The port's simulator-in-the-loop environment (``EnvBatch``,
``SimNavEnv``) against the JAX package's on one seeded world: features and
states, the observations of ``reset`` and ``step`` field by field (the
candidates and their features, the panorama features, the teacher), with
either engine behind the port's, and the observations against the port's
``NavRuntime`` tables."""

import numpy as np
import pytest

from visitron_torch import geometry as geo
from visitron_torch.agents import NavRuntime
from visitron_torch.data import EnvBatch, SceneFeatureTable, SimNavEnv
from visitron_torch.testing import SyntheticWorld as TWorld
from visitron_tpu.data import SceneFeatureTable as JTable
from visitron_tpu.data.env import EnvBatch as JEnvBatch
from visitron_tpu.data.env import SimNavEnv as JSimNavEnv
from visitron_tpu.testing import SyntheticWorld as JWorld

WORLD = dict(seed=7, num_scans=2, viewpoints_per_scan=24, scene_feat_dim=64)


@pytest.fixture(scope="module")
def worlds():
    jw, tw = JWorld(**WORLD), TWorld(**WORLD)
    jt = JTable.pack(jw.graphs, jw.scene_features(), vfov=60)
    tt = SceneFeatureTable.pack(tw.graphs, tw.scene_features(), vfov=60)
    return jw, tw, jt, tt


def _native(prefer_native):
    if prefer_native:
        import shutil

        if shutil.which("g++") is None:
            pytest.skip("no g++: the native engine cannot be built")
    return prefer_native


def _assert_obs_equal(tobs, jobs):
    assert len(tobs) == len(jobs)
    for t, j in zip(tobs, jobs):
        assert t.keys() == j.keys()
        for k in ("inst_idx", "scan", "viewpoint", "viewIndex", "heading", "elevation",
                  "step", "teacher"):
            assert t[k] == j[k], k
        np.testing.assert_array_equal(t["feature"], j["feature"])
        assert [loc.viewpointId for loc in t["navigableLocations"]] == [
            loc.viewpointId for loc in j["navigableLocations"]]
        assert len(t["candidate"]) == len(j["candidate"])
        for tc, jc in zip(t["candidate"], j["candidate"]):
            assert tc.keys() == jc.keys()
            for k in tc:
                if k == "feature":
                    np.testing.assert_allclose(tc[k], jc[k], atol=1e-12)
                else:
                    assert tc[k] == pytest.approx(jc[k], abs=1e-12), k


@pytest.mark.parametrize("pano", [True, False])
def test_env_batch_states_and_features_match_jax(worlds, pano):
    jw, tw, jt, tt = worlds
    jenv = JEnvBatch(jw.graphs, jt, batch_size=2, pano_features=pano, prefer_native=False)
    tenv = EnvBatch(tw.graphs, tt, batch_size=2, pano_features=pano)
    scan = tw.scans[0]
    vps = tw.graphs[scan].viewpoints[:2]
    for env in (jenv, tenv):
        env.new_episodes([scan, scan], vps, [0.0, 1.0])
    for actions in ([(0, 1.0, 0.0), (0, 0.0, 0.0)], [(0, 0.0, 1.0), (0, -1.0, -1.0)]):
        for (tf, ts), (jf, js), vp in zip(tenv.get_states(), jenv.get_states(), vps):
            np.testing.assert_array_equal(tf, jf)
            assert ts.location.viewpointId == js.location.viewpointId
            assert ts.viewIndex == js.viewIndex
        for env in (jenv, tenv):
            env.make_actions(actions)
    for env in (jenv, tenv):
        env.make_actions_at_index((0, -1.0, 0.0), 1)
    assert [s.viewIndex for _, s in tenv.get_states()] == [
        s.viewIndex for _, s in jenv.get_states()]


@pytest.mark.parametrize("prefer_native", [False, True])
def test_sim_nav_env_observations_match_jax(worlds, prefer_native):
    """reset, then steps that turn and move (the first navigable location
    when there is one): every observation equals the JAX package's."""
    jw, tw, jt, tt = worlds
    jitems = jw.ndh_items("train", 3, start_idx=5000)
    titems = tw.ndh_items("train", 3, start_idx=5000)
    assert jitems == titems
    jenv = JSimNavEnv(jw.graphs, jt, batch_size=3, path_type="planner_path",
                      prefer_native=False)
    tenv = SimNavEnv(tw.graphs, tt, batch_size=3, path_type="planner_path",
                     prefer_native=_native(prefer_native))
    jobs, tobs = jenv.reset(jitems), tenv.reset(titems)
    _assert_obs_equal(tobs, jobs)
    for k in range(6):
        actions = [(1 if len(o["navigableLocations"]) > 1 and k % 2 else 0,
                    1.0 if k % 3 else -1.0, 0.0) for o in jobs]
        jobs, tobs = jenv.step(actions), tenv.step(actions)
        _assert_obs_equal(tobs, jobs)
    # The candidate cache's second pass gives the same observations.
    _assert_obs_equal(tenv._get_obs(), jenv._get_obs())


def test_sim_nav_env_observations_match_the_runtime_tables(worlds):
    """The live candidates are the port's NavRuntime tables' (the same
    neighbours, pointIds and navigable indices); the teacher is the next hop
    to the path's goal; the panorama carries the base view's angle table."""
    _, tw, _, tt = worlds
    rt = NavRuntime.build(tw.graphs, tt, device="cpu")
    items = tw.ndh_items("train", 3, start_idx=5000)
    env = SimNavEnv(tw.graphs, tt, batch_size=3, path_type="planner_path")
    for i, ob in enumerate(env.reset(items)):
        row = rt.row(ob["scan"], ob["viewpoint"])
        n = int(rt.count_h[row])
        by_vp = {c["viewpointId"]: c for c in ob["candidate"]}
        assert len(ob["candidate"]) == n
        for slot in range(n):
            _, nbr_vp = rt.row_to_id(int(rt.nbr_h[row, slot]))
            assert by_vp[nbr_vp]["pointId"] == rt.point_h[row, slot]
            assert by_vp[nbr_vp]["idx"] == rt.nav_idx_h[row, slot]
        g = tw.graphs[ob["scan"]]
        assert ob["teacher"] == g.next_on_path(ob["viewpoint"], items[i]["planner_path"][-1])
        np.testing.assert_allclose(ob["feature"][:, -4:],
                                   geo.all_point_angle_feature()[ob["viewIndex"]])
