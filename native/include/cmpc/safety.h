// Executed-separation safety filter: float64 twin of the JAX filter
// (colaborativempc_tpu/runtime/simulate.py _sep_filter_beta — see its
// docstring for the full geometry derivation and measurement citations).
//
// Per-agent advance fractions beta in [0, 1] along the executed
// x0-shift such that no pair's executed distance falls below
// g = min(floor, its standstill distance) — monotone non-worsening.
// Braking is priority-asymmetric (larger prio = arc progress s leads,
// ties broken toward the lower index): the follower brakes along its
// own segment when a stopped follower satisfies g against the moved
// leader; both scale by the symmetric common factor otherwise; a final
// all-stop fallback (every beta = 0, exactly the standstill distances)
// backstops the guarantee against per-agent beta coupling. A symmetric
// stop must never be the first resort — it is a fixed point the fleet
// can park in (round-5 study).
#pragma once

#include <algorithm>
#include <cmath>
#include <vector>

namespace cmpc {

// p0, p1: n x 2 row-major current / candidate (X, Y); prio: n (arc s);
// beta: n output. Betas are exactly 1.0 when no pair would cross floor_d.
inline void sep_filter_betas(int n, const double* p0, const double* p1,
                             const double* prio, double floor_d,
                             double* beta, int n_pass = 4) {
  const double f2 = floor_d * floor_d;
  std::vector<double> dx(n), dy(n);
  for (int i = 0; i < n; ++i) {
    dx[i] = p1[2 * i] - p0[2 * i];
    dy[i] = p1[2 * i + 1] - p0[2 * i + 1];
    beta[i] = 1.0;
  }
  auto d0sq = [&](int i, int j) {
    const double ax = p0[2 * i] - p0[2 * j];
    const double ay = p0[2 * i + 1] - p0[2 * j + 1];
    return ax * ax + ay * ay;
  };
  // largest t in [0, 1] with the convex d^2(t) >= g^2 given
  // d^2(0) - g^2 = c >= 0 (smaller root; the negative set is an interval)
  // shaved by 1e-3 so braked agents stop marginally short of the floor
  // (exact landing makes later steps float boundary cases — see the
  // JAX twin's comment)
  auto brake_root = [](double ab, double bb, double c) {
    const double disc = ab * ab - bb * c;
    const double root = (-ab - std::sqrt(std::max(disc, 0.0)))
                        / std::max(bb, 1e-12);
    return std::min(std::max(root, 0.0), 1.0) * (1.0 - 1e-3);
  };
  for (int pass = 0; pass < n_pass; ++pass) {
    std::vector<double> t(n, 1.0);
    for (int i = 0; i < n; ++i) {
      for (int j = 0; j < n; ++j) {
        if (i == j) continue;
        const double g2 = std::min(f2, d0sq(i, j));
        const double ax = p0[2 * i] - p0[2 * j];
        const double ay = p0[2 * i + 1] - p0[2 * j + 1];
        const double bx = beta[i] * dx[i] - beta[j] * dx[j];
        const double by = beta[i] * dy[i] - beta[j] * dy[j];
        const double bb = bx * bx + by * by;
        const double ab = ax * bx + ay * by;
        const double d1sq = d0sq(i, j) + 2.0 * ab + bb;
        if (d1sq >= g2) continue;            // pair ends at/above g
        const double t_sym = brake_root(ab, bb, d0sq(i, j) - g2);
        // follower rule: mover m brakes along its segment against the
        // other o FIXED at its current-beta position; valid only when a
        // stopped m already satisfies g (cf >= 0)
        auto follower_t = [&](int m, int o, double* t_out) {
          const double qx = p0[2 * o] + beta[o] * dx[o];
          const double qy = p0[2 * o + 1] + beta[o] * dy[o];
          const double afx = p0[2 * m] - qx, afy = p0[2 * m + 1] - qy;
          const double cf = afx * afx + afy * afy - g2;
          if (cf < 0.0) return false;
          const double bfx = beta[m] * dx[m], bfy = beta[m] * dy[m];
          *t_out = brake_root(afx * bfx + afy * bfy,
                              bfx * bfx + bfy * bfy, cf);
          return true;
        };
        const bool i_follows = (prio[i] < prio[j])
                               || (prio[i] == prio[j] && i > j);
        double tf;
        if (i_follows) {
          t[i] = std::min(t[i], follower_t(i, j, &tf) ? tf : t_sym);
        } else if (!follower_t(j, i, &tf)) {
          t[i] = std::min(t[i], t_sym);      // leader bound symmetrically
        }
      }
    }
    for (int i = 0; i < n; ++i) beta[i] *= t[i];
  }
  // all-stop fallback (guarantee backstop against beta coupling)
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j) {
      if (i == j) continue;
      const double pxi = p0[2 * i] + beta[i] * dx[i];
      const double pyi = p0[2 * i + 1] + beta[i] * dy[i];
      const double pxj = p0[2 * j] + beta[j] * dx[j];
      const double pyj = p0[2 * j + 1] + beta[j] * dy[j];
      const double ddx = pxi - pxj, ddy = pyi - pyj;
      const double dsq = ddx * ddx + ddy * ddy;
      // float32-safe non-worsening margin, mirroring the JAX twin (a
      // 1e-9 margin froze fleets on rounding noise — see its comment)
      const double margin = std::max(1e-4 * d0sq(i, j), 1e-7);
      if (dsq < f2 && dsq < d0sq(i, j) - margin) {
        for (int a = 0; a < n; ++a) beta[a] = 0.0;
        return;
      }
    }
}

// Physical execution envelope on one executed state row (float64 twin
// of runtime/simulate.py lateral_wall): the applied x0-shift must be
// kinematically reachable — arc advance bounded, |ey| clamped to
// max(wall_frac * halfwidth(s), current |ey|) (outward past the wall
// blocked, inward recovery never), velocities clamped to the limits,
// epsi wrapped, (X, Y) rebuilt from the clamped Frenet pose. Apply
// BEFORE sep_filter_betas, as in the JAX ordering. Returns whether it
// clamped anything.
template <typename TrackT>
inline bool lateral_wall_exec(const TrackT& trk, double wall_frac,
                              const double* x_cur, double* x_exec,
                              double dt = 0.025, double max_vel = 5.5,
                              double min_vel = 0.0) {
  bool clamped = false;
  const double ds_raw = x_exec[6] - x_cur[6];
  const double ds = std::min(std::max(ds_raw, -max_vel * dt),
                             2.0 * max_vel * dt);
  const double s_new = x_cur[6] + ds;
  const double hw = trk.halfwidth(s_new);
  const double bound = std::max(hw * wall_frac, std::fabs(x_cur[3]));
  const double ey_new = std::min(std::max(x_exec[3], -bound), bound);
  if (ey_new != x_exec[3] || s_new != x_exec[6]) {
    double X, Y, th;
    trk.global_position(s_new, ey_new, &X, &Y, &th);
    x_exec[3] = ey_new;
    x_exec[6] = s_new;
    x_exec[7] = X;
    x_exec[8] = Y;
    clamped = true;
  }
  const double vx = std::min(std::max(x_exec[0], min_vel), max_vel);
  const double vy = std::min(std::max(x_exec[1], -max_vel), max_vel);
  const double wz = std::min(std::max(x_exec[2], -4.0 * M_PI),
                             4.0 * M_PI);
  if (vx != x_exec[0] || vy != x_exec[1] || wz != x_exec[2]) {
    x_exec[0] = vx;
    x_exec[1] = vy;
    x_exec[2] = wz;
    clamped = true;
  }
  if (std::fabs(x_exec[4]) > M_PI) {
    x_exec[4] = std::remainder(x_exec[4], 2.0 * M_PI);
    clamped = true;
  }
  return clamped;
}

}  // namespace cmpc
