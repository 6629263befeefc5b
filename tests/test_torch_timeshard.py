"""Time-sharded onsets of the port (`gat_tpu_torch/parallel/timeshard.py`)
at world 8 on gloo against gat_tpu's on its virtual 8-device mesh, and
against the port's own single-device envelope, on the four cases of
tests/test_timeshard.py: a 10-pluck song, its onsets, a length whose
frames divide the shards exactly (344 = 8 x 43, JAX's shards; the port's
hold whole rounds of four frames, so its exact case is 352 = 8 x 44,
where the last shard's halo is the real tail), and a quiet song whose
loudest samples are its last (the peak over real frames only).

Tolerances: the envelope atol 1e-3 against JAX's (test_timeshard's own
bound against single-device), atol 1e-4 against the port's single-device
`onset_strength` (the same fp32 math framed from another origin); onsets
identical to JAX's and to the port's single-device `detect_onsets`.
"""
import numpy as np
import pytest
import torch

from gat_tpu_torch.parallel import launch

SR = 22050


def _rank(signals: dict) -> dict:
    from gat_tpu_torch.parallel.mesh import make_mesh
    from gat_tpu_torch.parallel.timeshard import (detect_onsets_timesharded,
                                                  onset_envelope_timesharded)
    mesh = make_mesh(device="cpu")
    out = {name: {"env": onset_envelope_timesharded(y, mesh, SR).numpy()}
           for name, y in signals.items()}
    o, v, ovf, cap, n = detect_onsets_timesharded(signals["song"], mesh,
                                                  sr=SR)
    out["song"]["onsets"] = o[v].numpy()
    out["song"]["flags"] = (bool(ovf), bool(cap), int(n))
    return out


def _long_song(n_notes=10, spacing=0.7):
    from tests.conftest import make_pluck
    freqs = [82.41, 110.0, 146.83, 196.0, 246.94, 329.63]
    y = np.zeros(int((n_notes * spacing + 1.0) * SR), np.float32)
    for k in range(n_notes):
        n = make_pluck(freqs[k % len(freqs)], SR, 0.45, seed=k)
        fade = int(0.3 * len(n))
        n[-fade:] *= np.linspace(1, 0, fade, dtype=np.float32)
        s = int((0.4 + k * spacing) * SR)
        y[s:s + len(n)] += n
    return y


@pytest.fixture(scope="module")
def signals():
    even = (0.4 * np.sin(2 * np.pi * 220.0 * np.arange(175616) / SR)
            ).astype(np.float32)  # 344 = 8 x 43 frames, loud to the end
    loud_tail = _long_song(n_notes=6, spacing=0.7) * 0.05
    loud_tail[-400:] = 0.9
    even_rounds = (0.4 * np.sin(2 * np.pi * 196.0 * np.arange(179712) / SR)
                   ).astype(np.float32)  # 352 = 8 x 44 frames
    return {"song": _long_song(), "even": even, "even_rounds": even_rounds,
            "loud_tail": loud_tail}


@pytest.fixture(scope="module")
def world8(signals):
    return launch.spawn(_rank, 8, signals, device="cpu", timeout_s=300)


@pytest.mark.parametrize("name", ["song", "even", "even_rounds",
                                  "loud_tail"])
def test_envelope_matches_jax_and_single_device(world8, signals, name):
    import jax.numpy as jnp
    from gat_tpu.parallel import make_mesh
    from gat_tpu.parallel.timeshard import onset_envelope_timesharded
    from gat_tpu_torch.ops.onset import onset_strength
    y = signals[name]
    ref = np.asarray(onset_envelope_timesharded(jnp.asarray(y),
                                                make_mesh(8), SR))
    single = onset_strength(torch.from_numpy(y)[None], SR)[0].numpy()
    assert len(single) == 1 + len(y) // 512
    for r in world8:
        env = r[name]["env"]
        assert env.shape == single.shape
        np.testing.assert_allclose(env, ref[:len(env)], atol=1e-3)
        np.testing.assert_allclose(env, single, atol=1e-4)


def test_onsets_match_jax_and_single_device(world8, signals):
    import jax.numpy as jnp
    from gat_tpu.parallel import make_mesh
    from gat_tpu.parallel.timeshard import detect_onsets_timesharded
    from gat_tpu_torch.ops.onset import detect_onsets
    y = signals["song"]
    o, v, *_ = detect_onsets_timesharded(jnp.asarray(y), make_mesh(8), sr=SR)
    ref = np.asarray(o)[np.asarray(v)]
    assert len(ref) == 10  # every pluck found
    so, sv, *_ = detect_onsets(torch.from_numpy(y)[None], sr=SR,
                               max_onsets=256)
    single = so[0][sv[0]].numpy()
    for r in world8:
        np.testing.assert_array_equal(r["song"]["onsets"], ref)
        np.testing.assert_array_equal(r["song"]["onsets"], single)
        assert r["song"]["flags"] == (False, False, 10)
