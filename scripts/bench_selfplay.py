"""Self-play throughput benchmark: vs-pool vs plain self-play train steps
at 16384 envs (Connect Four, hidden 512, K=8 stacked opponents).

bench.py's selfplay_pool path is the maintained apples-to-apples
measurement of the same comparison; this script sweeps it at a larger
env count. Not measured on the H100 yet.
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax, jax.numpy as jnp
from burn_ppo_tpu.config import Config
from burn_ppo_tpu.envs import make_env
from burn_ppo_tpu.parallel.mesh import make_mesh, replicate, shard_rollout_carry
from burn_ppo_tpu.ppo.normalization import ObsNormState
from burn_ppo_tpu.ppo.rollout import init_rollout_carry
from burn_ppo_tpu.ppo.pool_rollout import PoolSeating
from burn_ppo_tpu.ppo.update import PPOUpdateConfig, make_optimizer
from burn_ppo_tpu.train import TrainState, build_network_for_env, make_pool_train_step, make_train_step

E=16384; T=64; K=8
cfg = Config(env="connect_four", num_envs=E, num_steps=T, total_steps=10**9,
    hidden_size=512, num_hidden=2, num_minibatches=4, num_epochs=4, seed=0,
    clip_epsilon=0.1, opponent_pool_fraction=0.25)
mesh = make_mesh(); env = make_env("connect_four")
net = build_network_for_env(env, cfg)
tx = make_optimizer(PPOUpdateConfig(max_grad_norm=0.5, adam_epsilon=1e-5))
k = jax.random.split(jax.random.PRNGKey(0), 5)
params = replicate(net.init(k[0]), mesh)
opt = replicate(tx.init(jax.device_get(params)), mesh)
carry = shard_rollout_carry(init_rollout_carry(env, E, k[1]), mesh)
st = TrainState(params=params, opt_state=opt, carry=carry, obs_norm=None, popart=None, update_key=k[2])
L = E - E//4
seating = PoolSeating.create(E, L, 2, num_slots=K, key=k[3])
opp = jax.tree_util.tree_map(lambda x: jnp.stack([x]*K), jax.device_get(params))
opp = replicate(opp, mesh)

step = make_pool_train_step(net, env, cfg, tx, L, K)
@jax.jit
def runN(st, seating, opp, n=4):
    def body(c, _):
        s, seat, acc = c
        s2, seat2, m, stats, _pool = step(s, seat, opp, None, jnp.float32(1e-3), jnp.float32(0.05), jnp.float32(0.0))
        return (s2, seat2, acc + m["policy_loss"] + stats["count"]), None
    (sf, seatf, acc), _ = jax.lax.scan(body, (st, seating, jnp.zeros(())), None, length=n)
    return acc
float(runN(st, seating, opp))
t0=time.perf_counter(); float(runN(st, seating, opp)); dt=(time.perf_counter()-t0)/4
print(f"pool step: {dt*1e3:.0f} ms -> {E*T/dt:.0f} env-steps/s (c4, hidden 512, K=8)")

# compare with non-pool path same config — SYMMETRIC bookkeeping: fold
# stats["count"] into the live checksum exactly like runN does, so XLA
# can't dead-code-eliminate the episode-stat summaries from only the
# selfplay side (that asymmetry overstated selfplay throughput and thus
# pool overhead).
step2 = make_train_step(net, env, cfg, tx, compact_stats=True)
@jax.jit
def runN2(st, n=4):
    def body(c, _):
        s, acc = c
        s2, m, stats = step2(s, jnp.float32(1e-3), jnp.float32(0.05), jnp.float32(0.0))
        return (s2, acc + m["policy_loss"] + stats["count"]), None
    (sf, acc), _ = jax.lax.scan(body, (st, jnp.zeros(())), None, length=n)
    return acc
float(runN2(st))
t0=time.perf_counter(); float(runN2(st)); dt2=(time.perf_counter()-t0)/4
print(f"selfplay step: {dt2*1e3:.0f} ms -> {E*T/dt2:.0f} env-steps/s")
