// Native host-side graph construction for the radar GNN data plane.
//
// The per-sample CPU hot path of the reference is a dense N×N pairwise
// distance matrix plus a FULL argsort per row
// (modules/compute_features/graph_features.py:58-84 — SURVEY.md hot loop
// #3).  This library replaces it for the host input pipeline: blocked
// distance computation, partial selection (nth_element) instead of a full
// sort, bitset adjacency with symmetrisation, row-major edge extraction
// (matching np.where ordering exactly), ball-query degrees, and fused
// edge-feature computation — one pass, no temporaries, no Python.
//
// Exposed as a C ABI for ctypes (no pybind11 dependency).
//
// The port's copy of the JAX package's native/graph_builder.cpp, compiled
// with the same flags (ops/_build.HOST_FLAGS: -O3 -march=native -fPIC
// -std=c++17 -shared), so that both libraries compute the same bits on one
// machine.  Built on first use by ops/_build.build_host into
// build/torch_kernels/ and loaded by data/native.py.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline double sq(double v) { return v * v; }

}  // namespace

extern "C" {

// Builds the symmetrised kNN graph (+ball-query degree) and edge features.
//
// Inputs: per-measurement arrays of length n (float32 except ts: float64).
// Outputs (caller-allocated):
//   senders/receivers [e_cap]        directed edges, row-major order
//   und_s/und_r       [eu_cap]       upper-triangular undirected edges
//   degree            [n]            ball-query degree (float32)
//   edge_feat         [e_cap * 7]    (dx/10, dy/10, dl/10, dvx, dvy, dvl,
//                                     dt seconds) per directed edge
// Returns number of directed edges written, or -1 on capacity overflow;
// *n_und_out receives the undirected count.
int radar_build_graph(
    const float* px, const float* py,
    const float* vx, const float* vy,
    const double* ts,
    int n, int k, float eps_sq,
    int e_cap, int eu_cap,
    int* senders, int* receivers,
    int* und_s, int* und_r, int* n_und_out,
    float* degree,
    float* edge_feat) {
  if (n <= 0) {
    *n_und_out = 0;
    return 0;
  }
  const int kk = (k >= n) ? n : k + 1;  // includes self (graph_features.py:35)

  // Dense squared distances, one row at a time.
  std::vector<float> dist(static_cast<size_t>(n) * n);
  for (int i = 0; i < n; ++i) {
    float* row = dist.data() + static_cast<size_t>(i) * n;
    const float xi = px[i], yi = py[i];
    for (int j = 0; j < n; ++j) {
      const float dx = xi - px[j];
      const float dy = yi - py[j];
      row[j] = dx * dx + dy * dy;
    }
  }

  // Adjacency as a byte matrix (n <= a few thousand → fine).
  std::vector<uint8_t> adj(static_cast<size_t>(n) * n, 0);
  std::vector<int> idx(n);
  for (int i = 0; i < n; ++i) {
    const float* row = dist.data() + static_cast<size_t>(i) * n;
    for (int j = 0; j < n; ++j) idx[j] = j;
    // stable selection of the kk nearest (ties by index, like argsort
    // kind='stable'): nth_element with (dist, index) lexicographic order.
    auto cmp = [row](int a, int b) {
      return row[a] < row[b] || (row[a] == row[b] && a < b);
    };
    if (kk < n) {
      std::nth_element(idx.begin(), idx.begin() + kk, idx.end(), cmp);
    }
    for (int m = 0; m < kk; ++m) {
      const int j = idx[m];
      adj[static_cast<size_t>(i) * n + j] = 1;
      adj[static_cast<size_t>(j) * n + i] = 1;  // symmetrise
    }
  }
  for (int i = 0; i < n; ++i) adj[static_cast<size_t>(i) * n + i] = 0;

  // Ball-query degree (graph_features.py:76-78).
  for (int i = 0; i < n; ++i) {
    const float* row = dist.data() + static_cast<size_t>(i) * n;
    int d = 0;
    for (int j = 0; j < n; ++j) d += (row[j] <= eps_sq && j != i);
    degree[i] = static_cast<float>(d);
  }

  // Row-major edge extraction + fused edge features
  // (graph_features.py:79,147-164 — note the double /10 on dl).
  int e = 0;
  int eu = 0;
  for (int i = 0; i < n; ++i) {
    const uint8_t* arow = adj.data() + static_cast<size_t>(i) * n;
    for (int j = 0; j < n; ++j) {
      if (!arow[j]) continue;
      if (e >= e_cap) return -1;
      senders[e] = i;
      receivers[e] = j;
      float* f = edge_feat + static_cast<size_t>(e) * 7;
      const float dx = (px[i] - px[j]) * 0.1f;
      const float dy = (py[i] - py[j]) * 0.1f;
      const float dvx = vx[i] - vx[j];
      const float dvy = vy[i] - vy[j];
      f[0] = dx;
      f[1] = dy;
      f[2] = std::sqrt(dx * dx + dy * dy) * 0.1f;
      f[3] = dvx;
      f[4] = dvy;
      f[5] = std::sqrt(dvx * dvx + dvy * dvy);
      f[6] = static_cast<float>((ts[i] - ts[j]) * 1e-6);
      ++e;
      if (j > i) {
        if (eu >= eu_cap) return -1;
        und_s[eu] = i;
        und_r[eu] = j;
        ++eu;
      }
    }
  }
  *n_und_out = eu;
  return e;
}

// SE(2) ego compensation of a window of frames into the last frame's
// vehicle frame (modules/data_utils/meas_sync.py:52-103).  px/py are
// modified in place; frame w spans [offsets[w], offsets[w+1]).
void radar_ego_compensate(
    float* px, float* py,
    const int* offsets, int n_frames,
    const double* ego_x, const double* ego_y, const double* ego_yaw) {
  if (n_frames <= 0) return;
  const double cx = ego_x[n_frames - 1];
  const double cy = ego_y[n_frames - 1];
  const double cth = ego_yaw[n_frames - 1];
  const double cc = std::cos(cth), cs = std::sin(cth);
  for (int w = 0; w < n_frames; ++w) {
    // T_rel = inv(T_curr) * T_prev
    const double pc = std::cos(ego_yaw[w]), ps = std::sin(ego_yaw[w]);
    const double r00 = cc * pc + cs * ps;
    const double r01 = cc * ps * -1.0 + cs * pc;
    const double r10 = -cs * pc + cc * ps;
    const double r11 = cs * ps + cc * pc;
    const double dxw = ego_x[w] - cx;
    const double dyw = ego_y[w] - cy;
    const double tx = cc * dxw + cs * dyw;
    const double ty = -cs * dxw + cc * dyw;
    for (int m = offsets[w]; m < offsets[w + 1]; ++m) {
      const double x = px[m], y = py[m];
      px[m] = static_cast<float>(r00 * x + r01 * y + tx);
      py[m] = static_cast<float>(r10 * x + r11 * y + ty);
    }
  }
}

// Stationary gating (modules/data_utils/meas_selection.py:53-69,169-200
// without RANSAC): flag[i] = |vr_pred(azimuth_i) - vr_i| <= gamma.
void radar_gate_stationary(
    const float* azimuth, const float* vr, int n,
    double tx, double ty, double theta,
    double vx_odom, double yawrate_odom, double gamma,
    uint8_t* flag) {
  const double vx_s0 = vx_odom - yawrate_odom * ty;
  const double vy_s0 = 0.0 + yawrate_odom * tx;
  // rotate by -theta into the sensor frame
  const double c = std::cos(-theta), s = std::sin(-theta);
  const double vx_s = vx_s0 * c - vy_s0 * s;
  const double vy_s = vx_s0 * s + vy_s0 * c;
  for (int i = 0; i < n; ++i) {
    const double pred =
        -(vx_s * std::cos(azimuth[i]) + vy_s * std::sin(azimuth[i]));
    flag[i] = std::fabs(pred - vr[i]) <= gamma ? 1 : 0;
  }
}

}  // extern "C"
