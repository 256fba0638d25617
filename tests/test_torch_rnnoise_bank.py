"""The RNNoise denoiser over 16 mono streams in one call, on the CPU.

bench.py's `rnnoise_bank16_realtime_x` runs `jax.vmap(denoise_frames_fast)`
over 16 mono denoiser states (bench.py:359-376).  The port runs the same 16
streams as the channels of one `denoise_frames_fast` call at C = 16: its
front end, the GRU stack (kernel R1 on the card, one block a channel) and
the synthesis treat channels independently, with a silence flag per
channel.  The input is bench.py's: uniform in +-0.3, times 32767, seeded,
here at K = 4 + 3 frames over two calls (the state carried between them),
with one stream that starts with two silent frames (the only frames the
silence flag takes: the high-pass filter's tail keeps later zeros above its
energy floor).

Gates, those of tests/test_torch_rnnoise.py for denoise_frames_fast: the
output within FAST_TOL = 0.25 s16 units, the synthesis memory within
FAST_TOL and the GRU states within 1e-4 relative to 1 + |ref|.  The VADs
against the JAX package are held to the front end's feature gate, VAD_TOL =
1e-4, not to RNN_TOL = 1e-5: on bench.py's full-band noise the two
packages' features differ by up to 1.4e-5 (their FFTs and products sum in
other orders; 1.5e-6 on the harmonic signal of test_torch_rnnoise.py), and
the VAD, a sigmoid of one GRU over them, moves as much (1.4e-5 measured; the
port's mono call reads 1.1e-5 against the JAX mono call, so the gap is not
the streams').  The port's 16-stream call is also held to 16 calls of one
stream each, within FAST_TOL and RNN_TOL (the same functions per channel;
the batched products may block their sums otherwise).

With `-s` the test prints the measured output and VAD gaps.

Torch runs on one intra-op thread (tests/torch_parity_helpers.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gst_plugins_rs_tpu.ops import rnnoise as J
from gst_plugins_rs_tpu_torch.ops import rnnoise as T
from torch_parity_helpers import port_on_cpu

STREAMS = 16
FRAME = T.FRAME_SIZE
K1, K2 = 4, 3
FAST_TOL = 0.25  # s16 units
RNN_TOL = 1e-5
VAD_TOL = 1e-4
STATE_TOL = 1e-4
SILENT_STREAM, SILENT_FRAMES = 5, 2  # a stream that starts silent


@pytest.fixture(autouse=True)
def _on_cpu():
    with port_on_cpu():
        yield


def _weights(kind):
    return J.random_weights(0) if kind == "random" else J.default_weights()


def _bank_frames(seed=0):
    """[16, K1 + K2, 1, FRAME] as bench.py draws them, one stream starting
    silent."""
    rng = np.random.RandomState(seed)
    a = rng.uniform(-0.3, 0.3, (STREAMS, K1 + K2, 1, FRAME)).astype(np.float32) * 32767
    a[SILENT_STREAM, :SILENT_FRAMES] = 0.0
    return a


def _streams_as_channels(chunk):
    """[16, K, 1, FRAME] -> [K, 16, FRAME]."""
    return torch.from_numpy(np.ascontiguousarray(chunk[:, :, 0].transpose(1, 0, 2)))


def _rel_state_err(js, ts):
    return max(float((np.abs(np.asarray(a) - b.numpy()) / (1.0 + np.abs(np.asarray(a)))).max())
               for a, b in zip(js, ts))


@pytest.mark.parametrize("kind", ["random", "packaged"])
def test_denoise_16_streams_matches_jax_vmap(kind):
    w = _weights(kind)
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    tw = T.weights_to(w, "cpu")
    bank = jax.jit(jax.vmap(lambda s, fr: J.denoise_frames_fast(s, jw, fr), in_axes=(0, 0)))
    js = jax.vmap(lambda _: J.denoise_init(1))(jnp.arange(STREAMS))
    ts = T.denoise_init(STREAMS, "cpu")
    frames = _bank_frames()
    for first, chunk in ((True, frames[:, :K1]), (False, frames[:, K1:])):
        js, jo, jv = bank(js, jnp.asarray(chunk))  # [16, K, 1, FRAME], [16, K, 1]
        ts, to, tv = T.denoise_frames_fast(ts, tw, _streams_as_channels(chunk))
        assert to.shape == (chunk.shape[1], STREAMS, FRAME)
        jo = np.asarray(jo)[:, :, 0].transpose(1, 0, 2)
        out_gap = np.abs(jo - to.numpy()).max()
        vad_gap = np.abs(np.asarray(jv)[:, :, 0].T - tv.numpy()).max()
        print(f"{kind} weights, {'first' if first else 'second'} call: output gap "
              f"{out_gap:.3g} s16 (gate {FAST_TOL}), VAD gap {vad_gap:.3g} (gate {VAD_TOL})")
        assert out_gap <= FAST_TOL
        assert vad_gap <= VAD_TOL
        if first:  # the silent frames of one stream: its VADs are zeroed, the others' not
            jv = np.asarray(jv)[:, :, 0]
            assert (tv[:SILENT_FRAMES, SILENT_STREAM] == 0).all()
            assert (jv[SILENT_STREAM, :SILENT_FRAMES] == 0).all()
            assert (tv[:SILENT_FRAMES] != 0).sum() == SILENT_FRAMES * (STREAMS - 1)
    np.testing.assert_allclose(ts.synthesis_mem.numpy(), np.asarray(js.synthesis_mem)[:, 0],
                               atol=FAST_TOL)
    assert _rel_state_err([np.asarray(h)[:, 0] for h in js.rnn], ts.rnn) <= STATE_TOL


def test_denoise_16_streams_matches_16_mono_calls():
    tw = T.weights_to(J.default_weights(), "cpu")
    frames = _bank_frames(seed=1)
    bank = T.denoise_init(STREAMS, "cpu")
    monos = [T.denoise_init(1, "cpu") for _ in range(STREAMS)]
    for chunk in (frames[:, :K1], frames[:, K1:]):
        bank, out, vad = T.denoise_frames_fast(bank, tw, _streams_as_channels(chunk))
        for i in range(STREAMS):
            monos[i], o, v = T.denoise_frames_fast(
                monos[i], tw, torch.from_numpy(np.ascontiguousarray(chunk[i])))
            assert float((o[:, 0] - out[:, i]).abs().max()) <= FAST_TOL
            assert float((v[:, 0] - vad[:, i]).abs().max()) <= RNN_TOL
