"""LPV planner closed-loop tests.

Behavioural parity targets from the reference experiments
(LPV_HP_N_main.py + recorded data): track the reference velocity, stay
inside the shrunk lane band, make forward progress, and in multi-agent runs
keep the inter-vehicle separation (slacked, as in the reference).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from colaborativempc_tpu.config import (
    ExperimentConfig, lpv_gains, x0_database,
)
from colaborativempc_tpu.geometry import make_track, halfwidth
from colaborativempc_tpu.runtime import run_lpv_experiment


def cfg_solver():
    from colaborativempc_tpu.config import SolverConfig
    return SolverConfig()


def small_cfg(**kw):
    base = dict(n_agents=1, N=15, dt=0.025, max_it=80, map_type="oval",
                gains=lpv_gains(), verb=0)
    base.update(kw)
    return ExperimentConfig(**base)


@pytest.fixture(scope="module")
def single_run():
    cfg = small_cfg()
    return cfg, run_lpv_experiment(cfg)


def test_single_agent_feasible_and_progresses(single_run):
    cfg, res = single_run
    assert res.steps > 50
    assert res.feasible.all()
    s = res.states[:, 0, 6]
    assert s[-1] > 2.0                       # made real progress
    assert (np.diff(s) > -1e-3).all()        # monotone progress


def test_single_agent_tracks_velocity(single_run):
    cfg, res = single_run
    vx = res.states[:, 0, 0]
    # settles near vx_ref = 3.0 (soft target, reference ECC2024 fig)
    assert abs(float(np.mean(vx[40:])) - cfg.limits.vx_ref) < 0.5
    assert float(np.max(vx)) < cfg.limits.max_vel + 0.1


def test_single_agent_stays_in_lane(single_run):
    cfg, res = single_run
    track = make_track(cfg.map_type)
    s = jnp.asarray(res.states[:, 0, 6])
    hw = np.asarray(halfwidth(track, s, sm=cfg.limits.sm))
    ey = res.states[:, 0, 3]
    # within the slack-softened band (slack Qs=1e7 keeps violations tiny)
    assert (np.abs(ey) <= hw + 0.05).all()


def test_single_agent_respects_input_limits(single_run):
    cfg, res = single_run
    u = res.inputs[:, 0, :]
    assert (u[:, 0] <= cfg.limits.max_rs + 1e-3).all()
    assert (u[:, 0] >= -cfg.limits.max_ls - 1e-3).all()
    assert (u[:, 1] <= cfg.limits.max_ac + 1e-3).all()
    assert (u[:, 1] >= -cfg.limits.max_dc - 1e-3).all()


def test_three_agents_keep_separation():
    cfg = small_cfg(n_agents=3, map_type="Highway", max_it=60)
    res = run_lpv_experiment(cfg)
    assert res.steps > 30
    assert res.feasible.all()
    # pairwise min distance across the horizon stays above half the safety
    # distance (the reference enforces D/2 per-agent side of the plane)
    assert float(res.min_dist.min()) > cfg.limits.min_dist / 2 * 0.9
    # all agents progress
    s_end = res.states[-1, :, 6]
    assert (s_end > 1.0).all()


def test_agents_diverge_from_head_on():
    """Two agents at the same s on the same lane must separate laterally."""
    cfg = small_cfg(n_agents=2, map_type="Highway", max_it=40)
    x0s = x0_database(2).copy()
    x0s[0, 3] = 0.05   # nearly same lateral offset
    x0s[1, 3] = -0.05
    res = run_lpv_experiment(cfg, x0s=x0s)
    assert res.feasible.all()
    # separation must grow from the initial 0.1 towards min_dist
    assert float(res.min_dist[-1]) > 0.25
    assert float(res.min_dist.min()) >= 0.099  # never worse than start


def test_eight_agent_fleet():
    """Fleets beyond the reference's 4 canonical agents: staggered platoon
    starts stay feasible and separated (BASELINE.json config #4)."""
    cfg = small_cfg(n_agents=8, map_type="Highway", max_it=15, N=10)
    res = run_lpv_experiment(cfg)
    assert res.steps >= 15
    assert res.feasible.all()
    assert float(res.min_dist_exec.min()) > 0.2


def test_full_lap_completion():
    """A single agent completes a full closed-track lap: exercises s
    wrapping, curvature transitions on all segments, and the lap
    termination logic (reference checkEnd semantics)."""
    cfg = small_cfg(max_it=500, map_type="oval", N=15)
    res = run_lpv_experiment(cfg)
    assert res.finished, (res.steps, res.states[-1, 0, 6])
    track = make_track(cfg.map_type)
    L = float(track.track_length[0])
    assert res.states[-1, 0, 6] >= L - 0.2
    # lane kept for the entire lap
    hw = np.asarray(halfwidth(track, jnp.asarray(res.states[:, 0, 6]),
                              sm=cfg.limits.sm))
    assert (np.abs(res.states[:, 0, 3]) <= hw + 0.06).all()


def test_multilane_experiment():
    """Running on lane 1 of a multi-lane track (reference set_lane /
    Oval2): the agent follows the inner lane's geometry."""
    cfg = small_cfg(n_agents=1, map_type="Oval2", max_it=40)
    cfg = dataclasses.replace(cfg, lane=1)
    res = run_lpv_experiment(cfg)
    assert res.feasible.all()
    track = make_track("Oval2")
    # lane 1 starts at y = 2*2*hw = 2.0; the agent must stay near lane 1's
    # centerline band, not lane 0's
    assert abs(res.states[0, 0, 8] - 2.0) < 0.3
    assert res.states[-1, 0, 6] > 1.0


def test_overtaking():
    """Heterogeneous fleet: a fast agent overtakes a slow leader on the
    same lane line, swerving laterally while keeping the safety distance
    (per-agent limits generalise the reference's shared sys_lim)."""
    from colaborativempc_tpu.config import SysLimits
    lim = SysLimits()._replace(vx_ref=np.array([3.0, 0.6]))
    cfg = ExperimentConfig(
        n_agents=2, N=20, dt=0.025, max_it=150, map_type="Highway",
        gains=lpv_gains(), limits=lim,
        solver=cfg_solver()._replace(admm_iters=400))
    x0s = x0_database(2).copy()
    x0s[0, 0] = 1.5; x0s[0, 3] = 0.0; x0s[0, 6] = 0.0   # fast, behind
    x0s[1, 0] = 0.6; x0s[1, 3] = 0.0; x0s[1, 6] = 0.8   # slow, ahead
    res = run_lpv_experiment(cfg, x0s=x0s)
    s = res.states[:, :, 6]
    assert res.feasible.all()
    assert bool(s[-1, 0] > s[-1, 1])                    # overtook
    assert float(res.min_dist_exec.min()) > 0.25        # safely
    # the overtake used lateral motion
    assert float(np.abs(res.states[:, 0, 3]).max()) > 0.2


def test_out_of_band_recovery():
    """Starting outside the shrunk lane band (a soft-constraint violation
    from step one) must not abort — the planner steers back into the band
    (the reference's slack design exists exactly for this,
    LPV_Planner.py:294-303)."""
    cfg = small_cfg(n_agents=1, max_it=60)
    x0s = x0_database(1).copy()
    x0s[0, 3] = 0.62          # band is 0.55 * 0.9 = 0.495
    res = run_lpv_experiment(cfg, x0s=x0s)
    assert res.feasible.all()
    assert abs(res.states[-1, 0, 3]) < 0.45


def test_blocked_road_brake_and_bypass():
    """A stopped vehicle ahead: the follower brakes, keeps the safety
    distance, and passes when there is room."""
    from colaborativempc_tpu.config import SysLimits
    lim = SysLimits()._replace(vx_ref=np.array([3.0, 0.0]),
                               max_vel=np.array([5.5, 0.01]))
    cfg = ExperimentConfig(
        n_agents=2, N=20, dt=0.025, max_it=80, map_type="SL",
        gains=lpv_gains(), limits=lim,
        solver=cfg_solver()._replace(admm_iters=400))
    x0s = x0_database(2).copy()
    x0s[0, 0] = 2.0; x0s[0, 3] = 0.0; x0s[0, 6] = 0.0
    x0s[1, 0] = 0.0; x0s[1, 1] = 0.0; x0s[1, 2] = 0.0
    x0s[1, 3] = 0.0; x0s[1, 6] = 1.2
    res = run_lpv_experiment(cfg, x0s=x0s)
    assert res.feasible.all()
    assert float(res.min_dist_exec.min()) > 0.22
    vx0 = res.states[:, 0, 0]
    assert float(vx0.min()) < 1.5          # braked for the obstacle
    assert res.states[-1, 0, 6] > 2.0      # and got past it


@pytest.mark.parametrize("track_name", ["L_shape", "8_track", "SLAM_shape1",
                                        "3110"])
def test_all_track_families_drivable(track_name):
    """Closed-loop driving on every remaining track family: negative-
    curvature arcs (L_shape), the self-intersecting figure eight, and the
    tight SLAM/3110 circuits."""
    cfg = small_cfg(n_agents=1, map_type=track_name, max_it=100)
    res = run_lpv_experiment(cfg)
    assert res.steps == 100
    assert res.feasible.all()
    assert res.states[-1, 0, 6] > 5.0
    track = make_track(track_name)
    s = jnp.asarray(res.states[:, 0, 6])
    hw = np.asarray(halfwidth(track, s, sm=cfg.limits.sm))
    assert (np.abs(res.states[:, 0, 3]) <= hw + 0.05).all()


def test_dynamic_lane_follows_agent():
    """Oval2 two-lane dynamic lane selection (reference set_lane/checkLane,
    track_initialization.py:302,418-436): an agent physically in lane 1 gets
    lane-1 constraint tables even though cfg.lane=0; after an external
    displacement into lane 0 the planner re-localises onto lane 0 and the
    run stays feasible with the new lane's bounds."""
    from colaborativempc_tpu.geometry import (
        frenet_to_cartesian, select_lane,
    )
    from colaborativempc_tpu.runtime import init_lpv_fleet
    from colaborativempc_tpu.runtime.simulate import make_lpv_fleet_step

    cfg = small_cfg(n_agents=1, N=10, map_type="Oval2", lane=0,
                    dynamic_lane=True)
    track = make_track(cfg.map_type)

    # start the agent in LANE 1 (warm start built on lane 1)
    cfg_init = dataclasses.replace(cfg, lane=1)
    x0 = np.asarray(x0_database(1))
    state = init_lpv_fleet(track, cfg_init, x0)

    step = jax.jit(make_lpv_fleet_step(track, cfg))
    lanes_seen = []
    for _ in range(6):
        state, metrics = step(state)
        assert np.asarray(metrics.feasible).all()
        lane, _ = select_lane(track, state.x0[0])
        lanes_seen.append(int(lane))
        # within lane-1 bounds of the SELECTED lane
        hw = float(halfwidth(track, float(state.x0[0, 6]), lane=int(lane)))
        assert abs(float(state.x0[0, 3])) <= hw + 0.05
    assert lanes_seen == [1] * 6, lanes_seen

    # external displacement: teleport the car onto lane 0 at the same
    # arc-length position (same heading), keeping velocities
    s_now = float(state.x0[0, 6])
    x1, y1, th1 = frenet_to_cartesian(track, s_now, 0.0, lane=1)
    x0_, y0_, th0 = frenet_to_cartesian(track, s_now, 0.0, lane=0)
    dx, dy, dth = float(x0_ - x1), float(y0_ - y1), float(th0 - th1)

    def shift(xrow):
        xrow = xrow.at[..., 7].add(dx)
        xrow = xrow.at[..., 8].add(dy)
        return xrow.at[..., 5].add(dth)

    state = state._replace(x0=shift(state.x0), x_pred=shift(state.x_pred))
    for _ in range(4):
        state, metrics = step(state)
        assert np.asarray(metrics.feasible).all()
    lane, xloc = select_lane(track, state.x0[0])
    assert int(lane) == 0, int(lane)
    hw = float(halfwidth(track, float(xloc[6]), lane=0))
    assert abs(float(xloc[3])) <= hw + 0.05
    # forward progress continued after the lane switch
    assert float(state.x0[0, 6]) > s_now


def test_heterogeneous_fleet_limits():
    """Per-agent SysLimits arrays (a slow leader being followed): each agent
    obeys ITS own velocity cap — generalises the reference's fleet-shared
    sys_lim (base_class.py:30-41) with zero cost for homogeneous fleets."""
    from colaborativempc_tpu.config import SysLimits
    from colaborativempc_tpu.runtime import run_lpv_experiment

    cfg = small_cfg(
        n_agents=2, N=12, dt=0.025, max_it=60, map_type="Highway",
        limits=SysLimits(vx_ref=np.array([1.2, 3.0]),
                         max_vel=np.array([1.4, 5.5])))
    res = run_lpv_experiment(cfg)
    assert res.feasible.all()
    vx = res.states[:, :, 0]
    # the slow leader saturates near ITS cap; the follower tracks ITS ref
    assert float(vx[10:, 0].max()) < 1.4 + 0.1
    assert float(vx[-1, 1]) > 1.6          # follower faster than the leader
    # separation held while the speed difference closes the gap
    assert res.min_dist_exec.min() > cfg.limits.min_dist * 0.8


def test_single_fleet_schedule_resolution():
    """run_lpv_experiment's N>=48 latency schedule fills only UNSET solver
    knobs (epoch 15, blocked-assoc Riccati, 1000-iteration cap — the
    full-course Highway study); explicit pins always win, and
    short horizons are untouched."""
    from colaborativempc_tpu.config import SolverConfig
    from colaborativempc_tpu.runtime.simulate import (
        resolve_single_fleet_schedule,
    )

    sv = resolve_single_fleet_schedule(
        ExperimentConfig(N=125, map_type="Highway")).solver
    assert (sv.epoch_len, sv.assoc, sv.admm_iters) == (15, True, 1000)

    pinned = SolverConfig(epoch_len=30, assoc=False, admm_iters=600)
    sv = resolve_single_fleet_schedule(
        ExperimentConfig(N=125, map_type="Highway", solver=pinned)).solver
    assert (sv.epoch_len, sv.assoc, sv.admm_iters) == (30, False, 600)

    short = ExperimentConfig(N=20, map_type="Highway")
    assert resolve_single_fleet_schedule(short) is short


def test_hold_on_infeasible_containment():
    """A solve that cannot converge within its budget must NOT be executed:
    with hold_on_infeasible (default) the fleet follows the previous plan
    one more stage (the reference MPCC's solver-failure reset analogue,
    mpc.cpp:231-252); with the flag off the unconverged iterate is applied
    (raw reference LPV semantics, LPV_Planner.py:241-249)."""
    import jax.numpy as jnp
    from colaborativempc_tpu.config import SolverConfig
    from colaborativempc_tpu.geometry import make_track
    from colaborativempc_tpu.runtime.simulate import (
        make_lpv_fleet_step, init_lpv_fleet,
    )

    # a 2-iteration budget from a COLD dual start cannot reach eps=1e-6
    track = make_track("Highway")
    base = dict(n_agents=2, N=12, dt=0.025, map_type="Highway",
                solver=SolverConfig(admm_iters=2, eps=1e-6, epoch_len=2))
    cfg_hold = ExperimentConfig(**base)
    cfg_raw = ExperimentConfig(**base, hold_on_infeasible=False)

    st0 = init_lpv_fleet(track, cfg_hold)
    st_h, m_h = make_lpv_fleet_step(track, cfg_hold)(st0)
    st_r, m_r = make_lpv_fleet_step(track, cfg_raw)(st0)

    assert not bool(np.asarray(m_h.feasible).any())
    # held: exactly the initial plan shifted by one stage, duals untouched
    expect_x = np.concatenate([np.asarray(st0.x_pred[:, 1:]),
                               np.asarray(st0.x_pred[:, -1:])], axis=1)
    assert np.allclose(np.asarray(st_h.x_pred), expect_x)
    assert np.allclose(np.asarray(st_h.w), np.asarray(st0.w))
    # raw: the unconverged iterate was executed (differs from the hold)
    assert not np.allclose(np.asarray(st_r.x_pred), expect_x)

    # and when solves DO converge, holding is the identity: both configs
    # produce the same trajectory
    base_ok = dict(n_agents=2, N=12, dt=0.025, map_type="Highway",
                   solver=SolverConfig(admm_iters=300, eps=1e-4))
    st_a = init_lpv_fleet(track, ExperimentConfig(**base_ok))
    st_b = st_a
    step_a = make_lpv_fleet_step(track, ExperimentConfig(**base_ok))
    step_b = make_lpv_fleet_step(
        track, ExperimentConfig(**base_ok, hold_on_infeasible=False))
    for _ in range(5):
        st_a, ma = step_a(st_a)
        st_b, mb = step_b(st_b)
        assert bool(np.asarray(ma.feasible).all())
        assert np.allclose(np.asarray(st_a.x_pred), np.asarray(st_b.x_pred))


def test_escalation_ladder_recovers_poisoned_agent():
    """Recovery escalation (the fleet-path port of the reference MPCC
    driver's n_no_solves ladder, mpc.cpp:231-252): an agent whose ADMM dual
    warm state is poisoned solves infeasibly every step and, with plain
    plan-holding, jams FOREVER (holds keep the pre-failure warm state).
    hold_reset_k consecutive holds reset the warm state and the agent
    recovers; without the ladder the jam persists."""
    from colaborativempc_tpu.config import SolverConfig, lpv_gains
    from colaborativempc_tpu.geometry import make_track
    from colaborativempc_tpu.runtime.simulate import (
        make_lpv_fleet_step, init_lpv_fleet,
    )
    import jax.numpy as jnp

    track = make_track("Highway")
    base = dict(n_agents=2, N=12, dt=0.025, map_type="Highway",
                gains=lpv_gains(), solver=SolverConfig(admm_iters=60,
                                                       eps=1e-4))
    cfg = ExperimentConfig(**base, hold_reset_k=2, hold_cold_k=6)
    cfg_off = ExperimentConfig(**base, hold_reset_k=None, hold_cold_k=None)

    st0 = init_lpv_fleet(track, cfg)
    y = np.array(st0.y)
    y[0] = 1e5                      # poisoned dual warm state for agent 0
    st0 = st0._replace(y=jnp.asarray(y))

    step = make_lpv_fleet_step(track, cfg)
    step_off = make_lpv_fleet_step(track, cfg_off)
    s1 = s2 = st0
    feas1, feas2 = [], []
    for _ in range(4):
        s1, m1 = step(s1)
        s2, m2 = step_off(s2)
        feas1.append(np.asarray(m1.feasible))
        feas2.append(np.asarray(m2.feasible))
    feas1, feas2 = np.asarray(feas1), np.asarray(feas2)
    # healthy agent 1 is untouched in both runs
    assert feas1[:, 1].all() and feas2[:, 1].all()
    # jam: agent 0 infeasible while the poisoned duals persist
    assert not feas1[:2, 0].any() and not feas2[:, 0].any()
    # recovery: the warm-state reset at hold_count >= 2 fixes step 3 onward
    assert feas1[2:, 0].all()
    assert int(s1.hold_count[0]) == 0
    # without the ladder the hold count just keeps climbing
    assert int(s2.hold_count[0]) == 4


def test_escalate_holds_cold_reinit_unit():
    """hold_count >= hold_cold_k replaces the agent's plan with a fresh
    warm-start trajectory from its CURRENT state (the per-agent
    generateNewInitialGuess, mpc.cpp:175-196), resets the ADMM warm state
    and restarts the hold budget; other agents are untouched."""
    from colaborativempc_tpu.config import lpv_gains
    from colaborativempc_tpu.geometry import make_track
    from colaborativempc_tpu.runtime.simulate import (
        escalate_holds, init_lpv_fleet,
    )
    from colaborativempc_tpu.utils.warmstart import warmstart_trajectory
    import jax.numpy as jnp

    track = make_track("Highway")
    cfg = ExperimentConfig(n_agents=2, N=10, dt=0.025, map_type="Highway",
                           gains=lpv_gains(), hold_reset_k=3, hold_cold_k=6)
    st = init_lpv_fleet(track, cfg)
    st = st._replace(
        hold_count=jnp.asarray([6, 0], jnp.int32),
        w=jnp.ones_like(st.w), y=jnp.ones_like(st.y),
        rho_scale=2.0 * jnp.ones_like(st.rho_scale),
        x_pred=st.x_pred + 0.5)          # stale plan, distinct from fresh
    lanes = jnp.zeros(2, jnp.int32)
    out = escalate_holds(track, cfg, st, lanes)

    x_ws, u_ws = warmstart_trajectory(track, st.x0[0], cfg.N, cfg.dt, lane=0)
    assert np.allclose(np.asarray(out.x_pred[0]), np.asarray(x_ws))
    assert np.allclose(np.asarray(out.w[0]), 0.0)
    assert np.allclose(np.asarray(out.rho_scale[0]), 1.0)
    assert int(out.hold_count[0]) == 0
    # agent 1 untouched
    assert np.allclose(np.asarray(out.x_pred[1]), np.asarray(st.x_pred[1]))
    assert np.allclose(np.asarray(out.w[1]), 1.0)
    # identity when nobody escalates
    st_ok = st._replace(hold_count=jnp.zeros(2, jnp.int32))
    out_ok = escalate_holds(track, cfg, st_ok, lanes)
    for a, b in zip(out_ok, st_ok):
        assert np.allclose(np.asarray(a), np.asarray(b))


def test_hold_sep_boost_noop_without_holds():
    """hold_sep_boost only scales the separation reward toward neighbours
    with a NONZERO hold counter, so on an all-feasible trajectory it is an
    exact no-op (the canonical experiments and benchmarks are unchanged by
    the round-4 hardening)."""
    from colaborativempc_tpu.config import SolverConfig
    from colaborativempc_tpu.runtime.simulate import (
        make_lpv_fleet_step, init_lpv_fleet,
    )
    track = make_track("Highway")
    base = dict(n_agents=3, N=12, dt=0.025, map_type="Highway",
                gains=lpv_gains(), solver=SolverConfig(admm_iters=300))
    step_on = make_lpv_fleet_step(
        track, ExperimentConfig(**base, hold_sep_boost=3.0))
    step_off = make_lpv_fleet_step(
        track, ExperimentConfig(**base, hold_sep_boost=0.0))
    sa = sb = init_lpv_fleet(track, ExperimentConfig(**base))
    for _ in range(4):
        sa, ma = step_on(sa)
        sb, mb = step_off(sb)
        assert bool(np.asarray(ma.feasible).all())
        assert np.allclose(np.asarray(sa.x_pred), np.asarray(sb.x_pred))


def test_hold_sep_boost_pushes_away_from_holding_neighbour():
    """A neighbour with hold_count > 0 broadcasts a stale plan (its tail
    collapses toward a stationary point — the round-4 near-pass failure
    mode); with hold_sep_boost the other agents' separation
    reward toward THAT neighbour is scaled up, so their next plans keep
    more distance from it than without the boost."""
    import jax.numpy as jnp
    from colaborativempc_tpu.config import SolverConfig
    from colaborativempc_tpu.runtime.simulate import (
        make_lpv_fleet_step, init_lpv_fleet,
    )
    track = make_track("Highway")
    base = dict(n_agents=2, N=12, dt=0.025, map_type="Highway",
                gains=lpv_gains(),
                solver=SolverConfig(admm_iters=300),
                # ladder off so the hold flag persists untouched
                hold_reset_k=None, hold_cold_k=None)
    st0 = init_lpv_fleet(track, ExperimentConfig(**base))
    # place the agents close so the separation reward is active, and mark
    # agent 1 as holding
    x0 = np.array(st0.x0)
    xp = np.array(st0.x_pred)
    x0[1] = x0[0]
    x0[1, 8] += 0.25                       # 0.25 m abreast of agent 0
    xp[1] = xp[0]
    xp[1, :, 8] += 0.25
    st0 = st0._replace(
        x0=jnp.asarray(x0), x_pred=jnp.asarray(xp),
        hold_count=jnp.asarray([0, 1], jnp.int32))

    def min_gap(cfg):
        # stage 0 is the (fixed) current state, so measure the horizon
        # TAIL where the reward can actually bend the plan
        st, _ = make_lpv_fleet_step(track, cfg)(st0)
        d = np.asarray(st.x_pred[0, 6:, 7:9]) - np.asarray(
            st0.x_pred[1, 6:, 7:9])
        return float(np.sqrt((d * d).sum(axis=1)).min())

    gap_on = min_gap(ExperimentConfig(**base, hold_sep_boost=6.0))
    gap_off = min_gap(ExperimentConfig(**base, hold_sep_boost=0.0))
    assert gap_on > gap_off + 1e-4, (gap_on, gap_off)
