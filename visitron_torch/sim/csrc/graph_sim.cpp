// Batched discretized graph simulator — native engine.
//
// Implements exactly the state machine documented in
// visitron_torch/sim/simulator.py (the port's copy of the JAX package's
// visitron_tpu/sim/csrc/graph_sim.cpp; rendering-free MatterSim semantics:
// 36 discretized views, heading wrap / elevation clamp, navigable locations
// = unobstructed neighbors within +-HFOV/2 of the camera heading sorted by
// angular distance).  The reference's equivalent is the external MatterSim
// C++ simulator built in its Dockerfile (Dockerfile:50-55), driven with
// rendering disabled (tasks/viewpoint_select/data_loader.py:40-46).
//
// Exposed as a C ABI for ctypes.  All
// viewpoints are identified by *global rows* — the caller (Python) owns the
// scan/viewpointId string mapping, mirroring NavRuntime's packed layout.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;
constexpr double kAngleInc = kPi / 6.0;  // 30 degrees

double normalize_angle(double a) {
  // Wrap into (-pi, pi].
  a = std::fmod(a, 2.0 * kPi);
  if (a <= -kPi) a += 2.0 * kPi;
  if (a > kPi) a -= 2.0 * kPi;
  return a;
}

struct Neighbor {
  int32_t row;        // global viewpoint row of the neighbor
  double heading;     // absolute bearing from the source viewpoint
  double elevation;
  double distance;    // metric distance
};

struct NavEntry {
  int32_t nbr_index;  // index into the source viewpoint's neighbor list
  double rel_heading;
  double rel_elevation;
};

struct World {
  // Per-viewpoint neighbor geometry, indexed by global row.
  std::vector<std::vector<Neighbor>> neighbors;
  std::vector<double> px, py, pz;

  // navigable cache: key = row * 36 + view.
  std::unordered_map<int64_t, std::vector<NavEntry>> nav_cache;
  double hfov = 0.0;

  const std::vector<NavEntry>& navigable(int32_t row, int32_t view) {
    int64_t key = static_cast<int64_t>(row) * 36 + view;
    auto it = nav_cache.find(key);
    if (it != nav_cache.end()) return it->second;
    const double cam_h = (view % 12) * kAngleInc;
    const double cam_e = (view / 12 - 1) * kAngleInc;
    std::vector<NavEntry> entries;
    const auto& nbrs = neighbors[row];
    entries.reserve(nbrs.size());
    for (int32_t i = 0; i < static_cast<int32_t>(nbrs.size()); ++i) {
      const double rel_h = normalize_angle(nbrs[i].heading - cam_h);
      if (std::fabs(rel_h) <= hfov / 2.0 + 1e-9) {
        entries.push_back({i, rel_h, nbrs[i].elevation - cam_e});
      }
    }
    // Stable sort by angular distance (ties keep neighbor order).
    std::stable_sort(entries.begin(), entries.end(),
                     [](const NavEntry& a, const NavEntry& b) {
                       const double da = a.rel_heading * a.rel_heading +
                                         a.rel_elevation * a.rel_elevation;
                       const double db = b.rel_heading * b.rel_heading +
                                         b.rel_elevation * b.rel_elevation;
                       return da < db;
                     });
    auto& slot = nav_cache[key];
    slot = std::move(entries);
    return slot;
  }
};

struct Sim {
  World* world = nullptr;
  int32_t batch = 0;
  std::vector<int32_t> row, hstep, erow, step;
};

int32_t snap_heading(double heading) {
  int32_t s = static_cast<int32_t>(std::lround(heading / kAngleInc)) % 12;
  return s < 0 ? s + 12 : s;
}

int32_t snap_elevation(double elevation) {
  int32_t r = static_cast<int32_t>(std::lround(elevation / kAngleInc)) + 1;
  return r < 0 ? 0 : (r > 2 ? 2 : r);
}

void apply(Sim* s, int i, int32_t index, double dh, double de) {
  if (index != 0) {
    const int32_t view = s->erow[i] * 12 + s->hstep[i];
    const auto& nav = s->world->navigable(s->row[i], view);
    const auto& nbrs = s->world->neighbors[s->row[i]];
    s->row[i] = nbrs[nav[index - 1].nbr_index].row;
  }
  if (dh > 0) s->hstep[i] = (s->hstep[i] + 1) % 12;
  else if (dh < 0) s->hstep[i] = (s->hstep[i] + 11) % 12;
  if (de > 0) { if (s->erow[i] < 2) ++s->erow[i]; }
  else if (de < 0) { if (s->erow[i] > 0) --s->erow[i]; }
  ++s->step[i];
}

}  // namespace

extern "C" {

void* vsim_world_new(double hfov) {
  auto* w = new World();
  w->hfov = hfov;
  return w;
}

void vsim_world_free(void* world) { delete static_cast<World*>(world); }

// Register `n` viewpoints with positions (n x 3, row-major) and `m`
// undirected edges (pairs of global rows).  Rows must be added in order:
// this call appends viewpoints [base, base + n).
int32_t vsim_world_add_viewpoints(void* world, int32_t n, const double* positions) {
  auto* w = static_cast<World*>(world);
  const int32_t base = static_cast<int32_t>(w->neighbors.size());
  for (int32_t i = 0; i < n; ++i) {
    w->px.push_back(positions[i * 3 + 0]);
    w->py.push_back(positions[i * 3 + 1]);
    w->pz.push_back(positions[i * 3 + 2]);
    w->neighbors.emplace_back();
  }
  return base;
}

void vsim_world_add_edges(void* world, int32_t m, const int32_t* edges) {
  auto* w = static_cast<World*>(world);
  for (int32_t e = 0; e < m; ++e) {
    const int32_t u = edges[e * 2], v = edges[e * 2 + 1];
    const double dx = w->px[v] - w->px[u];
    const double dy = w->py[v] - w->py[u];
    const double dz = w->pz[v] - w->pz[u];
    const double horiz = std::sqrt(dx * dx + dy * dy);
    const double dist = std::sqrt(dx * dx + dy * dy + dz * dz);
    // Matterport convention: heading clockwise from +Y.
    double h_uv = std::fmod(kPi / 2.0 - std::atan2(dy, dx), 2.0 * kPi);
    if (h_uv < 0) h_uv += 2.0 * kPi;
    double h_vu = std::fmod(kPi / 2.0 - std::atan2(-dy, -dx), 2.0 * kPi);
    if (h_vu < 0) h_vu += 2.0 * kPi;
    w->neighbors[u].push_back({v, h_uv, std::atan2(dz, horiz), dist});
    w->neighbors[v].push_back({u, h_vu, std::atan2(-dz, horiz), dist});
  }
}

void* vsim_sim_new(void* world, int32_t batch) {
  auto* s = new Sim();
  s->world = static_cast<World*>(world);
  s->batch = batch;
  s->row.assign(batch, 0);
  s->hstep.assign(batch, 0);
  s->erow.assign(batch, 1);
  s->step.assign(batch, 0);
  return s;
}

void vsim_sim_free(void* sim) { delete static_cast<Sim*>(sim); }

void vsim_new_episode(void* sim, const int32_t* rows, const double* headings,
                      const double* elevations) {
  auto* s = static_cast<Sim*>(sim);
  for (int32_t i = 0; i < s->batch; ++i) {
    s->row[i] = rows[i];
    s->hstep[i] = snap_heading(headings[i]);
    s->erow[i] = snap_elevation(elevations[i]);
    s->step[i] = 0;
  }
}

void vsim_make_action(void* sim, const int32_t* index, const double* dh,
                      const double* de) {
  auto* s = static_cast<Sim*>(sim);
  for (int32_t i = 0; i < s->batch; ++i) apply(s, i, index[i], dh[i], de[i]);
}

void vsim_make_action_at(void* sim, int32_t i, int32_t index, double dh, double de) {
  apply(static_cast<Sim*>(sim), i, index, dh, de);
}

void vsim_get_state(void* sim, int32_t* rows, int32_t* views, int32_t* steps) {
  auto* s = static_cast<Sim*>(sim);
  for (int32_t i = 0; i < s->batch; ++i) {
    rows[i] = s->row[i];
    views[i] = s->erow[i] * 12 + s->hstep[i];
    steps[i] = s->step[i];
  }
}

// Fills up to `cap` navigable entries for batch element i (excluding the
// current location, which callers prepend).  Returns the count.
int32_t vsim_get_navigable(void* sim, int32_t i, int32_t cap, int32_t* out_rows,
                           double* out_rel_heading, double* out_rel_elevation,
                           double* out_distance) {
  auto* s = static_cast<Sim*>(sim);
  const int32_t view = s->erow[i] * 12 + s->hstep[i];
  const auto& nav = s->world->navigable(s->row[i], view);
  const auto& nbrs = s->world->neighbors[s->row[i]];
  const int32_t n = std::min<int32_t>(cap, static_cast<int32_t>(nav.size()));
  for (int32_t k = 0; k < n; ++k) {
    const auto& e = nav[k];
    out_rows[k] = nbrs[e.nbr_index].row;
    out_rel_heading[k] = e.rel_heading;
    out_rel_elevation[k] = e.rel_elevation;
    out_distance[k] = nbrs[e.nbr_index].distance;
  }
  return static_cast<int32_t>(nav.size());
}

}  // extern "C"
