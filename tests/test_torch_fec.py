"""The coded link's FEC layer in the port (``modem_tpu_torch.fec``: CRC,
scrambler, interleaver, puncturer, Reed–Solomon, the convolutional code and
the plain versions of kernel K13 in ``ops/viterbi_kernel.py``) against the
JAX package on the same numpy inputs.

Tolerances: none. Host tables, CRC bits and verdicts, keystreams,
interleaver and puncturer maps, RS codewords, decoded messages and ``ok``
flags, conv code bits and every Viterbi decision are exactly equal (the
Viterbi decisions against both of the JAX forms: the ``xla`` scan and the
Pallas kernel in interpret mode). Each JAX decode runs once, in a module
fixture.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from modem_tpu import fec as jfec
from modem_tpu.fec import conv as jconv
from modem_tpu.ops import pallas_viterbi as jpv

from modem_tpu_torch import fec as tfec
from modem_tpu_torch.fec import conv as tconv
from modem_tpu_torch.ops import viterbi_kernel as vk

torch.set_num_threads(1)

# (K, polynomials): CCSDS K=7 rate 1/2, K=7 rate 1/3, K=5, and K=4 (S = 8)
CODES = [(7, (0o171, 0o133)), (7, (0o171, 0o133, 0o165)), (5, (0o23, 0o35)),
         (4, (0o15, 0o17))]
CODE_IDS = [f"k{k}_r1_{len(p)}" for k, p in CODES]
PALLAS_IDS = CODE_IDS[:3]


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _eq(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(got, want)


def _noisy_llrs(code, shape, n_data, sigma, seed):
    """Data bits and the LLRs of their codeword in Gaussian noise, float32."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, shape + (n_data,)).astype(np.int32)
    c = np.asarray(code.encode(jnp.asarray(bits))).astype(np.float32)
    y = 1.0 - 2.0 * c + sigma * rng.normal(size=c.shape).astype(np.float32)
    return bits, (2.0 * y / sigma ** 2).astype(np.float32)


# ---------------------------------------------------------------------------
# CRC
# ---------------------------------------------------------------------------

CRCS = {"crc16_ccitt": (jfec.crc16_ccitt, tfec.crc16_ccitt),
        "crc32_mpeg2": (jfec.crc32_mpeg2, tfec.crc32_mpeg2),
        "crc8_custom": (lambda: jfec.Crc(8, 0x07, init=0x5A, xorout=0x3C),
                        lambda: tfec.Crc(8, 0x07, init=0x5A, xorout=0x3C))}


@pytest.mark.parametrize("name", sorted(CRCS))
@pytest.mark.parametrize("length", [1, 1002])
def test_crc_affine_tables_equal(name, length):
    jh, jr = CRCS[name][0]()._affine(length)
    th, tr = CRCS[name][1]()._affine(length)
    _eq(th, jh)
    _eq(tr, jr)


@pytest.mark.parametrize("name", sorted(CRCS))
def test_crc_bits_and_verdicts_equal(name):
    jc, tc = CRCS[name][0](), CRCS[name][1]()
    rng = np.random.default_rng(len(name))
    bits = rng.integers(0, 2, (2, 3, 130)).astype(np.int32)
    _eq(tc.compute(_t(bits)), jc.compute(jnp.asarray(bits)))
    frame = np.asarray(jc.append(jnp.asarray(bits)))
    _eq(tc.append(_t(bits)), frame)
    flipped = frame.copy()
    flipped[0, :, 7] ^= 1            # a payload bit
    flipped[1, 1, -1] ^= 1           # a CRC bit
    got = tc.check(_t(flipped))
    assert got.dtype == torch.bool
    _eq(got, jc.check(jnp.asarray(flipped)))
    assert got.tolist() == [[False] * 3, [True, False, True]]


def test_crc_width_checked():
    for w in (1, 65):
        with pytest.raises(ValueError, match="width"):
            tfec.Crc(w, 0x3)


# ---------------------------------------------------------------------------
# scrambler
# ---------------------------------------------------------------------------

SCRAMBLERS = {"dvb": (jfec.dvb_scrambler, tfec.dvb_scrambler),
              "ieee80211": (jfec.ieee80211_scrambler,
                            tfec.ieee80211_scrambler),
              "ieee80211_seed5": (lambda: jfec.ieee80211_scrambler(5),
                                  lambda: tfec.ieee80211_scrambler(5))}


@pytest.mark.parametrize("name", sorted(SCRAMBLERS))
@pytest.mark.parametrize("length", [3, 1018])
def test_scrambler_block_matrices_equal(name, length):
    jc, ja = SCRAMBLERS[name][0]()._block_mats(length)
    tc, ta = SCRAMBLERS[name][1]()._block_mats(length)
    _eq(tc, jc)
    _eq(ta, ja)


@pytest.mark.parametrize("name", sorted(SCRAMBLERS))
def test_keystream_carried_over_blocks_equal(name):
    js, ts = SCRAMBLERS[name][0](), SCRAMBLERS[name][1]()
    jst = js.init_state((2,))
    tst = ts.init_state((2,), "cpu")
    _eq(tst, jst)
    for length in (17, 500, 33):
        jk, jst = js.keystream(jst, length)
        tk, tst = ts.keystream(tst, length)
        assert tk.dtype == torch.int32
        _eq(tk, jk)
        _eq(tst, jst)


def test_scramble_is_an_involution_and_equal():
    js, ts = jfec.dvb_scrambler(), tfec.dvb_scrambler()
    bits = np.random.default_rng(3).integers(0, 2, (4, 1018)).astype(np.int32)
    want, _ = js.scramble(jnp.asarray(bits), js.init_state((4,)))
    got, _ = ts.scramble(_t(bits), ts.init_state((4,), "cpu"))
    _eq(got, want)
    back, _ = ts.descramble(got, ts.init_state((4,), "cpu"))
    _eq(back, bits)


def test_scrambler_arguments_checked():
    with pytest.raises(ValueError, match="degree"):
        tfec.Scrambler(0b11, 1)
    with pytest.raises(ValueError, match="seed"):
        tfec.Scrambler((1 << 7) | (1 << 4) | 1, 0)
    with pytest.raises(ValueError, match="seed"):
        tfec.Scrambler((1 << 7) | (1 << 4) | 1, 1 << 7)


# ---------------------------------------------------------------------------
# interleaver and puncturer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows", [2, 8, 12])
def test_interleave_equal_and_round_trip(rows):
    x = np.random.default_rng(rows).normal(size=(2, 3, 96 * 4)).astype(
        np.float32)
    got = tfec.block_interleave(_t(x), rows)
    _eq(got, jfec.block_interleave(jnp.asarray(x), rows))
    _eq(tfec.block_deinterleave(got, rows),
        jfec.block_deinterleave(jnp.asarray(np.asarray(got)), rows))
    _eq(tfec.block_deinterleave(got, rows), x)


def test_interleave_length_checked():
    for fn in (tfec.block_interleave, tfec.block_deinterleave):
        with pytest.raises(ValueError, match="rows=5"):
            fn(torch.zeros(12), 5)


PATTERNS = {"rate23": tfec.rate23_pattern, "rate34": tfec.rate34_pattern}


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_puncturer_keep_map_equal(name):
    pat = PATTERNS[name]()
    _eq(pat, getattr(jfec, f"{name}_pattern")())
    jp, tp = jfec.Puncturer(pat), tfec.Puncturer(pat)
    _eq(tp._keep, jp._keep)
    assert tp.kept_per_period == jp.kept_per_period
    assert tp.out_bits(1638) == jp.out_bits(1638)
    assert tp.rate(0.5) == jp.rate(0.5)


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_puncture_depuncture_equal_and_round_trip(name):
    pat = PATTERNS[name]()
    jp, tp = jfec.Puncturer(pat), tfec.Puncturer(pat)
    steps = 6 * 30
    x = np.random.default_rng(5).normal(size=(2, 2 * steps)).astype(
        np.float32)
    kept = tp.puncture(_t(x))
    _eq(kept, jp.puncture(jnp.asarray(x)))
    back = tp.depuncture(kept, steps)
    _eq(back, jp.depuncture(jnp.asarray(np.asarray(kept)), steps))
    idx = tp._flat_indices(steps)
    _eq(back[..., idx], x[..., idx])
    gone = np.setdiff1d(np.arange(2 * steps), idx)
    assert gone.size and not back[..., gone].any()


def test_puncturer_arguments_checked():
    with pytest.raises(ValueError, match="0/1"):
        tfec.Puncturer(np.array([1, 0]))
    with pytest.raises(ValueError, match="deletes everything"):
        tfec.Puncturer(np.zeros((2, 2)))
    p = tfec.Puncturer(tfec.rate34_pattern())
    with pytest.raises(ValueError, match="period 3"):
        p.puncture(torch.zeros(2 * 10))
    with pytest.raises(ValueError, match="kept positions"):
        p.depuncture(torch.zeros(5), 6)


# ---------------------------------------------------------------------------
# Reed–Solomon
# ---------------------------------------------------------------------------

RS_CODES = {"rs_255_223": (jfec.rs_255_223, tfec.rs_255_223),
            "rs_dvb": (jfec.rs_dvb, tfec.rs_dvb)}
N_ERRORS = ("zero", "t", "t_plus_1")


@pytest.fixture(scope="module")
def rs_cases():
    """Per code: a batch of codewords with 0, t and t+1 symbol errors (two
    rows each), and the JAX decoder's ``(msg, ok)`` on it, run once."""
    out = {}
    for name, (jmake, _) in RS_CODES.items():
        jrs = jmake()
        rng = np.random.default_rng(len(name))
        msg = rng.integers(0, 256, (6, jrs.k)).astype(np.int32)
        cw = np.array(jrs.encode(jnp.asarray(msg)))
        for r, ne in enumerate((0, 0, jrs.t, jrs.t, jrs.t + 1, jrs.t + 1)):
            pos = rng.choice(jrs.n, ne, replace=False)
            cw[r, pos] ^= rng.integers(1, 256, ne).astype(np.int32)
        jmsg, jok = jax.jit(jrs.decode)(jnp.asarray(cw))
        out[name] = dict(msg=msg, recv=cw, jmsg=np.asarray(jmsg),
                         jok=np.asarray(jok))
    return out


@pytest.mark.parametrize("name", sorted(RS_CODES))
def test_rs_host_tables_equal(name):
    jrs, trs = RS_CODES[name][0](), RS_CODES[name][1]()
    _eq(trs._gen, jrs._gen)
    _eq(trs._encode_matrix(), jrs._encode_matrix())
    _eq(trs._syndrome_matrix(), jrs._syndrome_matrix())
    assert (trs.n, trs.k, trs.t, trs.fcr) == (jrs.n, jrs.k, jrs.t, jrs.fcr)


def test_gf_tables_equal_the_bit_sliced_arithmetic():
    """The port's product and inverse tables hold the values of the JAX
    package's gather-free multiply and ``x^254``, on every pair."""
    jrs, trs = jfec.rs_255_223(), tfec.rs_255_223()
    a, b = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    _eq(trs._gmul(_t(a), _t(b)), jrs._gmul(jnp.asarray(a), jnp.asarray(b)))
    x = np.arange(256)
    _eq(trs._ginv(_t(x)), jrs._ginv(jnp.asarray(x)))


@pytest.mark.parametrize("name", sorted(RS_CODES))
def test_rs_encode_and_syndromes_equal(name, rs_cases):
    jrs, trs = RS_CODES[name][0](), RS_CODES[name][1]()
    case = rs_cases[name]
    cw = trs.encode(_t(case["msg"]))
    _eq(cw, jrs.encode(jnp.asarray(case["msg"])))
    assert not trs.syndromes(cw).any()
    _eq(trs.syndromes(_t(case["recv"])),
        jrs.syndromes(jnp.asarray(case["recv"])))


@pytest.mark.parametrize("name", sorted(RS_CODES))
@pytest.mark.parametrize("errors", N_ERRORS)
def test_rs_decode_equal(name, errors, rs_cases):
    case = rs_cases[name]
    rows = slice(2 * N_ERRORS.index(errors), 2 * N_ERRORS.index(errors) + 2)
    msg, ok = RS_CODES[name][1]().decode(_t(case["recv"][rows]))
    _eq(msg, case["jmsg"][rows])
    _eq(ok, case["jok"][rows])
    if errors != "t_plus_1":
        assert ok.all() and np.array_equal(msg.numpy(), case["msg"][rows])


def test_rs_decode_bits_equal(rs_cases):
    case = rs_cases["rs_dvb"]
    jrs, trs = jfec.rs_dvb(), tfec.rs_dvb()
    bits = np.asarray(jrs._to_bits(jnp.asarray(case["recv"])))
    jmsg, jok = jax.jit(jrs.decode_bits)(jnp.asarray(bits))
    msg, ok = trs.decode_bits(_t(bits))
    _eq(msg, jmsg)
    _eq(ok, jok)
    _eq(trs.encode_bits(msg[:1]), jrs.encode_bits(jnp.asarray(jmsg[:1])))


def test_rs_arguments_checked():
    with pytest.raises(ValueError, match="0 < k < n"):
        tfec.ReedSolomon(256, 200)
    with pytest.raises(ValueError, match="even"):
        tfec.ReedSolomon(255, 222)
    rs = tfec.rs_dvb()
    with pytest.raises(ValueError, match="188 symbols"):
        rs.encode(torch.zeros(10, dtype=torch.int32))
    with pytest.raises(ValueError, match="204 symbols"):
        rs.decode(torch.zeros(10, dtype=torch.int32))


# ---------------------------------------------------------------------------
# the convolutional code and K13's plain versions
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def conv_cases():
    """Per code: noisy LLRs on a 2-D batch and the JAX decoders' outputs on
    them (full block soft and hard, windowed ``xla``; for the first three
    code shapes windowed ``pallas`` in interpret mode), each run once."""
    out = {}
    for (k, polys), cid in zip(CODES, CODE_IDS):
        jc = jconv.ConvCode(k, polys)
        bits, llr = _noisy_llrs(jc, (2, 3), 300, 1.5, k + len(polys))
        hard = (llr < 0).astype(np.int32)
        jl = jnp.asarray(llr)
        windowed = jax.jit(jc.decode_soft_windowed,
                           static_argnames=("block_steps", "backend"))
        out[cid] = dict(
            bits=bits, llr=llr, hard=hard,
            soft=np.asarray(jax.jit(jc.decode_soft)(jl)),
            hard_dec=np.asarray(jax.jit(jc.decode_hard)(jnp.asarray(hard))),
            xla=np.asarray(windowed(jl, block_steps=64, backend="xla")),
            xla96=np.asarray(windowed(jl[0], block_steps=96, backend="xla")))
        if cid in PALLAS_IDS:
            out[cid]["pallas"] = np.asarray(
                windowed(jl[0], block_steps=96, backend="pallas"))
    return out


def _codes(case_id):
    (k, polys), = [c for c, i in zip(CODES, CODE_IDS) if i == case_id]
    return jconv.ConvCode(k, polys), tconv.ConvCode(k, polys)


@pytest.mark.parametrize("cid", CODE_IDS)
def test_conv_tables_equal(cid):
    jc, tc = _codes(cid)
    _eq(tc._in_bit, jc._in_bit)
    _eq(tc._pred, jc._pred)
    _eq(tc._outs, jc._outs)
    assert (tc.n, tc.n_states, tc.rate()) == (jc.n, jc.n_states, jc.rate())


@pytest.mark.parametrize("cid", CODE_IDS)
def test_conv_encode_equal(cid, conv_cases):
    jc, tc = _codes(cid)
    bits = conv_cases[cid]["bits"]
    got = tc.encode(_t(bits))
    assert got.dtype == torch.int32
    _eq(got, jc.encode(jnp.asarray(bits)))


@pytest.mark.parametrize("cid", CODE_IDS)
def test_decode_soft_equal(cid, conv_cases):
    case = conv_cases[cid]
    got = _codes(cid)[1].decode_soft(_t(case["llr"]))
    _eq(got, case["soft"])
    assert (got.numpy() != case["bits"]).any()  # the noise is felt


@pytest.mark.parametrize("cid", CODE_IDS)
def test_decode_hard_equal(cid, conv_cases):
    case = conv_cases[cid]
    _eq(_codes(cid)[1].decode_hard(_t(case["hard"])), case["hard_dec"])


@pytest.mark.parametrize("cid", CODE_IDS)
def test_decode_soft_windowed_equal_xla(cid, conv_cases):
    """2-D batch, windows of 64 steps: K13's plain version against the JAX
    ``xla`` windowed scan."""
    case = conv_cases[cid]
    _eq(_codes(cid)[1].decode_soft_windowed(_t(case["llr"]), 64), case["xla"])


@pytest.mark.parametrize("cid", PALLAS_IDS)
def test_decode_soft_windowed_equal_pallas(cid, conv_cases):
    """Windows of 96 steps: against the JAX Pallas kernel in interpret
    mode (and its ``xla`` form)."""
    case = conv_cases[cid]
    got = _codes(cid)[1].decode_soft_windowed(_t(case["llr"][0]), 96)
    _eq(got, case["pallas"])
    _eq(got, case["xla96"])


@pytest.mark.parametrize("pin", [0.0, 1.0])
def test_viterbi_decode_windows_plain_equal(pin):
    """K13's plain version on ready windows, free and pinned ends, against
    the JAX Pallas kernel in interpret mode."""
    jc, tc = jconv.ccsds_code(), tconv.ccsds_code()
    _, llr = _noisy_llrs(jc, (4,), 150, 1.2, 21)
    win = llr.reshape(4, -1, 2)[:, 3:147]
    want = jax.jit(lambda w: jpv.viterbi_decode_windows(
        jc, w, jnp.float32(pin), interpret=True))(jnp.asarray(win))
    got = vk.viterbi_decode_windows(tc, _t(win), torch.tensor(pin))
    assert got.dtype == torch.int32
    _eq(got, want)


def test_windowed_stream_matches_jax_forms_with_a_starved_halo():
    """A 2-step halo breaks the agreement with the full-block decode, and
    the port still equals the JAX windowed form decision for decision."""
    jc, tc = jconv.ccsds_code(), tconv.ccsds_code()
    _, llr = _noisy_llrs(jc, (2,), 400, 1.1, 22)
    want, full = jax.jit(lambda x: (
        jc.decode_soft_windowed(x, 50, halo_steps=2, backend="xla"),
        jc.decode_soft(x)))(jnp.asarray(llr))
    got = tc.decode_soft_windowed(_t(llr), 50, halo_steps=2)
    _eq(got, want)
    assert (got.numpy() != np.asarray(full)).any()


def test_acs_end_state_forms():
    """``_acs`` with a given end-state tensor and the default state 0 equal
    the JAX forms."""
    jc, tc = jconv.ccsds_code(), tconv.ccsds_code()
    _, llr = _noisy_llrs(jc, (3,), 90, 1.0, 23)
    lam = llr.reshape(3, -1, 2)
    ends = np.array([0, 5, 63], np.int32)
    want = jax.jit(lambda x, e: (jc._acs(x, end_state=e),
                                 jc._acs(x, trim=False)))(
        jnp.asarray(lam), jnp.asarray(ends))
    _eq(tc._acs(_t(lam), end_state=_t(ends)), want[0])
    _eq(tc._acs(_t(lam), trim=False), want[1])


def _stream_pushes(sv, lam, block):
    outs = []
    for s0 in range(0, lam.shape[-2], block):
        blk = lam[..., s0:s0 + block, :]
        o = sv.push(blk.reshape(blk.shape[:-2] + (-1,)))
        if o is not None:
            outs.append(np.asarray(o))
    return outs


@pytest.fixture(scope="module")
def stream_case():
    """A 2-channel CCSDS stream of 640 steps and the JAX stream's pushes,
    run once."""
    jc = jconv.ccsds_code()
    bits, llr = _noisy_llrs(jc, (2,), 640 - 6, 1.3, 24)
    lam = llr.reshape(2, -1, 2)
    sv = jconv.StreamingViterbi(jc, 128)
    pushes = _stream_pushes(sv, jnp.asarray(lam), 128)
    return dict(bits=bits, llr=llr, lam=lam,
                jax=pushes + [np.asarray(sv.flush())])


def test_streaming_viterbi_equal_jax_stream_and_one_shot(stream_case):
    sv = tconv.StreamingViterbi(tconv.ccsds_code(), 128)
    lam = _t(stream_case["lam"])
    outs = _stream_pushes(sv, lam, 128) + [sv.flush().numpy()]
    assert len(outs) == len(stream_case["jax"]) == 5
    for got, want in zip(outs, stream_case["jax"]):
        _eq(got, want)
    one = tconv.ccsds_code().decode_soft_windowed(_t(stream_case["llr"]), 128)
    _eq(np.concatenate(outs, -1), one)


def test_streaming_viterbi_continues_a_jax_stream(stream_case):
    """Two pushes in the JAX package, its carry in numpy form, the rest in
    the port: the same decisions as the JAX stream."""
    jc = jconv.ccsds_code()
    lam = stream_case["lam"]
    jsv = jconv.StreamingViterbi(jc, 128)
    for s0 in (0, 128):
        blk = jnp.asarray(lam[:, s0:s0 + 128].reshape(2, -1))
        jsv.push(blk)
    sv = tconv.StreamingViterbi(tconv.ccsds_code(), 128)
    sv.set_state({"prev": np.asarray(jsv._prev),
                  "pretail": np.asarray(jsv._pretail)}, device="cpu")
    outs = _stream_pushes(sv, _t(lam[:, 256:]), 128) + [sv.flush().numpy()]
    for got, want in zip(outs, stream_case["jax"][1:]):
        _eq(got, want)
    st = sv.get_state()
    assert st["prev"] is None


def test_streaming_viterbi_arguments_checked():
    code = tconv.ccsds_code()
    with pytest.raises(ValueError, match="constraint length"):
        tconv.StreamingViterbi(code, 128, halo_steps=3)
    with pytest.raises(ValueError, match="block_steps must be >= halo"):
        tconv.StreamingViterbi(code, 32)
    sv = tconv.StreamingViterbi(code, 128)
    with pytest.raises(ValueError, match="nothing buffered"):
        sv.flush()
    with pytest.raises(ValueError, match="push exactly 128"):
        sv.push(torch.zeros(2 * 100))


def test_conv_arguments_checked():
    with pytest.raises(ValueError, match=">= 2"):
        tconv.ConvCode(1, (1,))
    with pytest.raises(ValueError, match="exceeds 3 bits"):
        tconv.ConvCode(3, (0o17,))
    with pytest.raises(ValueError, match="block_steps"):
        tconv.ccsds_code().decode_soft_windowed(torch.zeros(200), 0)


def test_kernel_limits_named():
    """Every code shape has a route: the warp route takes S <= 256 (S = 4
    included), n <= 32 and a row that fits shared memory; K = 10, 33 code
    bits and 30000-step windows take the block route, whose metrics and
    decisions move to the global scratch past shared memory."""
    assert vk.warp_route(tconv.ConvCode(3, (0o7, 0o5)), 100)
    assert vk.warp_route(tconv.ccsds_code(), 652)
    assert not vk.warp_route(tconv.ConvCode(10, (0o1001, 0o1777)), 100)
    assert not vk.warp_route(tconv.ccsds_code(), 30000)
    assert not vk.warp_route(tconv.ConvCode(3, (0o7,) * 33), 10)
    assert vk.smem_bytes_per_row(64, 2, 652) == 4 * (652 * 4 + 128)
    assert vk.row_layout(64, 2, 652) == (1304, 2608, 2736)
    assert vk.row_layout(8, 3, 10) == (30, 40, 56)
    head = 4 * (2 + 64)
    assert vk.block_plan(512, 2, 100) == (512, 1, 1, head + 4096 + 6400)
    assert vk.block_plan(64, 2, 30000) == (64, 1, 0, head + 512)
    assert vk.block_plan(64, 2, 20000) == (64, 1, 1, head + 512 + 160000)
    assert vk.block_plan(256, 2, 8000) == (256, 1, 0, head + 2048)
    assert vk.block_plan(1 << 15, 2, 40) == (1024, 0, 0, head)
    assert vk.block_plan(4, 2, 10)[0] == 32


def test_fec_exports_only_what_is_ported():
    assert set(tfec.__all__) < set(jfec.__all__)
    for name in ("Bch", "QcLdpc"):
        assert name not in tfec.__all__ and not hasattr(tfec, name)
    for name in ("PolarCode", "RateMatchedPolar", "TurboCode"):
        assert name in tfec.__all__
    for name in tfec.__all__:
        assert hasattr(tfec, name)
