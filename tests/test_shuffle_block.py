"""Epoch-shuffle tiling tests: resolver policy + learning invariance."""

import jax
import jax.numpy as jnp
import numpy as np

from burn_ppo_tpu.ppo.update import resolve_shuffle_block


def test_exact_at_reference_scales():
    # 32 envs x 128 steps (configs/cartpole.toml) -> exact shuffle
    assert resolve_shuffle_block(1024, 0) == 1
    # 128 x 64 (connect_four) -> exact
    assert resolve_shuffle_block(2048, 0) == 1


def test_default_is_exact_at_large_scale():
    """0 is exact at every batch size: the exact row gather costs about
    as much as tiles on the H100, so the default keeps the reference's
    per-sample shuffle."""
    n = 65536 * 128
    assert resolve_shuffle_block(n // 4, 0) == 1


def test_intermediate_scale():
    n = 4096 * 64  # the flagship's 262144 samples/update
    assert resolve_shuffle_block(n // 8, 0) == 1


def test_requested_one_is_exact():
    assert resolve_shuffle_block(10**7 // 4, 1) == 1


def test_requested_explicit():
    assert resolve_shuffle_block(1024, 64) == 64


def test_rounds_down_to_divisor_power_of_two():
    # mb_size 96: target 64 -> largest pow2 divisor chain: 2,4,8,16,32
    assert resolve_shuffle_block(96, 64) == 32


def test_tiled_update_still_trains():
    """PPO update with tile 16 reduces loss on a synthetic problem the
    same way the exact shuffle does (order within minibatch is
    irrelevant; only co-occurrence changes)."""
    from burn_ppo_tpu.envs import make_env
    from burn_ppo_tpu.models.network import make_network
    from burn_ppo_tpu.ppo.update import (
        PPOUpdateConfig,
        make_optimizer,
        ppo_update,
    )

    env = make_env("cartpole")
    net = make_network(env.spec, network_type="mlp", hidden_size=16,
                       num_hidden=1, activation="tanh")
    N = 1024
    key = jax.random.PRNGKey(0)
    ks = jax.random.split(key, 7)
    data = {
        "obs": jax.random.normal(ks[0], (N, 5)),
        "actions": jax.random.randint(ks[1], (N,), 0, 2),
        "old_log_probs": jnp.log(jnp.full((N,), 0.5)),
        "advantages": jax.random.normal(ks[2], (N,)),
        "returns": jax.random.normal(ks[3], (N,)),
        "old_values": jnp.zeros((N,)),
        "valid": jnp.ones((N,)),
    }
    params = net.init(ks[4])

    outs = {}
    for label, block in (("exact", 1), ("tiled", 16)):
        cfg = PPOUpdateConfig(num_epochs=2, num_minibatches=4,
                              shuffle_block_rows=block)
        tx = make_optimizer(cfg)
        p, o, _, metrics = ppo_update(
            net, tx, params, tx.init(params), data, None, ks[5],
            jnp.float32(1e-3), jnp.float32(0.01), cfg,
        )
        outs[label] = metrics
    # Both shuffles process all 8 minibatches and produce sane losses.
    for label, m in outs.items():
        assert float(m["num_minibatch_updates"]) == 8.0, label
        assert np.isfinite(float(m["policy_loss"]))
    # KL/clip statistics should be in the same ballpark (identical data,
    # different minibatch composition only).
    assert abs(
        float(outs["exact"]["approx_kl"]) - float(outs["tiled"]["approx_kl"])
    ) < 0.05


def test_uneven_minibatch_split_matches_explicit_padding():
    """N % nmb != 0: the internal pad (wrapped rows, valid=0, up to
    nmb*ceil(N/nmb)) must be BIT-IDENTICAL to handing ppo_update an
    already-even batch with the same explicit valid-zeroed rows appended
    — i.e. every real sample is used every epoch and pad rows contribute
    nothing (reference uneven split, ppo.rs:1811-1831)."""
    from burn_ppo_tpu.envs import make_env
    from burn_ppo_tpu.models.network import make_network
    from burn_ppo_tpu.ppo.update import (
        PPOUpdateConfig,
        make_optimizer,
        ppo_update,
    )

    env = make_env("cartpole")
    net = make_network(env.spec, network_type="mlp", hidden_size=16,
                       num_hidden=1, activation="tanh")
    N, nmb = 1022, 4  # ceil -> 256, pad 2
    key = jax.random.PRNGKey(3)
    ks = jax.random.split(key, 7)
    data = {
        "obs": jax.random.normal(ks[0], (N, 5)),
        "actions": jax.random.randint(ks[1], (N,), 0, 2),
        "old_log_probs": jnp.log(jnp.full((N,), 0.5)),
        "advantages": jax.random.normal(ks[2], (N,)),
        "returns": jax.random.normal(ks[3], (N,)),
        "old_values": jnp.zeros((N,)),
        "valid": jnp.ones((N,)),
    }
    pad = nmb * (-(-N // nmb)) - N
    data_even = {
        k: jnp.concatenate([v, v[:pad]], axis=0) for k, v in data.items()
    }
    data_even["valid"] = data_even["valid"].at[N:].set(0.0)

    cfg = PPOUpdateConfig(num_epochs=2, num_minibatches=nmb)
    tx = make_optimizer(cfg)
    params = net.init(ks[4])
    outs = []
    for d in (data, data_even):
        p, o, _, m = ppo_update(
            net, tx, params, tx.init(params), d, None, ks[5],
            jnp.float32(1e-3), jnp.float32(0.01), cfg,
        )
        outs.append((p, m))
    (p_a, m_a), (p_b, m_b) = outs
    for la, lb in zip(jax.tree_util.tree_leaves(p_a),
                      jax.tree_util.tree_leaves(p_b)):
        np.testing.assert_array_equal(np.asarray(la), np.asarray(lb))
    for k in m_a:
        np.testing.assert_array_equal(
            np.asarray(m_a[k]), np.asarray(m_b[k]), err_msg=k
        )
    assert float(m_a["num_minibatch_updates"]) == 2.0 * nmb


def test_all_pad_minibatches_are_skipped():
    """pad >= mb_size (N=10, nmb=8 -> mb_size 2, pad 6): shuffling can
    produce minibatches of ONLY pad rows. Those must be skipped outright
    — the regression ran Adam on stale momentum with zero grads and
    diluted the metric averages with zero-sum entries (count hit
    epochs*nmb regardless)."""
    from burn_ppo_tpu.envs import make_env
    from burn_ppo_tpu.models.network import make_network
    from burn_ppo_tpu.ppo.update import (
        PPOUpdateConfig,
        make_optimizer,
        ppo_update,
    )

    env = make_env("cartpole")
    net = make_network(env.spec, network_type="mlp", hidden_size=16,
                       num_hidden=1, activation="tanh")
    N, nmb, epochs = 10, 8, 2
    key = jax.random.PRNGKey(3)
    ks = jax.random.split(key, 7)
    data = {
        "obs": jax.random.normal(ks[0], (N, 5)),
        "actions": jax.random.randint(ks[1], (N,), 0, 2),
        "old_log_probs": jnp.log(jnp.full((N,), 0.5)),
        "advantages": jax.random.normal(ks[2], (N,)),
        "returns": jax.random.normal(ks[3], (N,)),
        "old_values": jnp.zeros((N,)),
        "valid": jnp.ones((N,)),
    }
    cfg = PPOUpdateConfig(num_epochs=epochs, num_minibatches=nmb)
    tx = make_optimizer(cfg)
    params = net.init(ks[4])
    p, o, _, m = ppo_update(
        net, tx, params, tx.init(params), data, None, ks[5],
        jnp.float32(1e-3), jnp.float32(0.01), cfg,
    )
    count = float(m["num_minibatch_updates"])
    # 10 valid rows over minibatches of 2: between 5 and 8 can hold a
    # valid row per epoch; the 6 pad rows guarantee at least one all-pad
    # minibatch for this seed (3 across 2 epochs at current shuffle).
    assert epochs * 5 <= count < epochs * nmb, count
    for k, v in m.items():
        assert np.isfinite(np.asarray(v)).all(), k
    for leaf in jax.tree_util.tree_leaves(p):
        assert np.isfinite(np.asarray(leaf)).all()
