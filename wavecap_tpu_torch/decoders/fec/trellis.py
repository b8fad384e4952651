"""P25 1/2-rate trellis codec (TSBK / PDU data protection).

Protocol (TIA-102.BAAA Annex E; table verified against the reference's
SDRTrunk-derived matrix, reference ``dsp/fec/trellis.py:44``): a 4-state
trellis, state = previous input dibit; each input dibit emits a 4-bit
constellation point (two transmitted dibits).  A 96-bit TSBK becomes
48 data dibits + 1 flush dibit -> 49 points -> 196 bits.

Decode is a fully vectorized numpy Viterbi over the 4 states with
hard-symbol Hamming metrics (soft metrics optional via symbol distances).
"""

from __future__ import annotations

import numpy as np

# OUTPUT_NIBBLE[state, input_dibit] -> 4-bit constellation point
# (two dibits: high dibit transmitted first). Next state == input dibit.
OUTPUT_NIBBLE = np.array(
    [
        [0x2, 0xC, 0x1, 0xF],
        [0xE, 0x0, 0xD, 0x3],
        [0x9, 0x7, 0xA, 0x4],
        [0x5, 0xB, 0x6, 0x8],
    ],
    np.uint8,
)

# Hamming distance between two 4-bit nibbles' dibit representation using
# symbol distance (how many of the 2 dibits differ, weighted by how far).
_NIBBLE_DIBITS = np.stack([(np.arange(16) >> 2) & 3, np.arange(16) & 3], axis=1)


def _dibit_distance() -> np.ndarray:
    """Pairwise distance between nibbles = sum of dibit mismatches (0/1 each)."""
    a = _NIBBLE_DIBITS[:, None, :]
    b = _NIBBLE_DIBITS[None, :, :]
    return (a != b).sum(axis=2).astype(np.float32)


_DIST = _dibit_distance()


def encode_dibits(data_dibits: np.ndarray) -> np.ndarray:
    """Encode input dibits (+ appended flush dibit 0) -> transmitted dibits."""
    state = 0
    out = np.empty(2 * (len(data_dibits) + 1), np.uint8)
    for i, d in enumerate(list(np.asarray(data_dibits, np.uint8)) + [0]):
        nib = OUTPUT_NIBBLE[state, d]
        out[2 * i] = (nib >> 2) & 3
        out[2 * i + 1] = nib & 3
        state = int(d)
    return out


def encode_bits(bits96: np.ndarray) -> np.ndarray:
    """96 bits -> 196 transmitted bits (with flush dibit)."""
    bits = np.asarray(bits96, np.uint8)
    dibits = (bits[0::2] << 1) | bits[1::2]
    out_dibits = encode_dibits(dibits)
    out = np.empty(2 * len(out_dibits), np.uint8)
    out[0::2] = (out_dibits >> 1) & 1
    out[1::2] = out_dibits & 1
    return out


def viterbi_decode_dibits(rx_dibits: np.ndarray) -> tuple[np.ndarray, int]:
    """Viterbi-decode received dibit pairs -> (input dibits, error metric).

    ``rx_dibits`` has even length 2*S; returns S-1 data dibits (the final
    flush dibit is dropped) and the accumulated branch-metric of the best
    path (0 = clean).
    """
    rx = np.asarray(rx_dibits, np.uint8)
    s_steps = len(rx) // 2
    rx_nibbles = (rx[0::2].astype(np.int32) << 2) | rx[1::2].astype(np.int32)

    # branch_cost[state, inp] for a given received nibble
    # metric table: _DIST[OUTPUT_NIBBLE[state, inp], rx_nibble]
    metrics = np.full(4, np.inf, np.float32)
    metrics[0] = 0.0
    backptr = np.zeros((s_steps, 4), np.uint8)  # best previous state per next-state

    for t in range(s_steps):
        cost = _DIST[OUTPUT_NIBBLE, rx_nibbles[t]]  # (state, inp)
        # next_state == inp: candidate[prev, ns] = metrics[prev] + cost[prev, ns]
        cand = metrics[:, None] + cost
        backptr[t] = np.argmin(cand, axis=0)
        metrics = cand[backptr[t], np.arange(4)]

    end_state = int(np.argmin(metrics))
    err = float(metrics[end_state])
    # traceback: input dibit at step t == state after step t
    states = np.empty(s_steps + 1, np.uint8)
    states[s_steps] = end_state
    for t in range(s_steps - 1, -1, -1):
        states[t] = backptr[t, states[t + 1]]
    inputs = states[1:]  # input at step t drives state t+1
    return inputs[:-1].copy(), int(err)


def viterbi_decode_bits(bits196: np.ndarray) -> tuple[np.ndarray, int]:
    """196 received bits -> (96 decoded bits, error metric)."""
    bits = np.asarray(bits196, np.uint8)
    rx_dibits = (bits[0::2] << 1) | bits[1::2]
    dibits, err = viterbi_decode_dibits(rx_dibits)
    out = np.empty(2 * len(dibits), np.uint8)
    out[0::2] = (dibits >> 1) & 1
    out[1::2] = dibits & 1
    return out, err


# Constellation symbol values for each dibit (P25 C4FM levels)
_DIBIT_VALUES = np.array([1.0, 3.0, -1.0, -3.0], np.float32)
# (16, 2): symbol pair for each output nibble
_NIBBLE_SYMBOLS = _DIBIT_VALUES[_NIBBLE_DIBITS]


def viterbi_decode_soft(soft_pairs: np.ndarray) -> tuple[np.ndarray, float]:
    """Soft-decision Viterbi over received symbol pairs.

    ``soft_pairs``: (S, 2) float soft symbols (C4FM scale, ±1/±3) — the
    two transmitted symbols per trellis step.  Euclidean branch metrics
    squeeze ~1.5-2 dB more out of marginal signals than hard slicing.
    Returns (S-1 input dibits, best path metric).
    """
    rx = np.asarray(soft_pairs, np.float32)
    s_steps = rx.shape[0]
    # nibble_cost[t, nib] = ||rx[t] - symbols(nib)||^2
    diff = rx[:, None, :] - _NIBBLE_SYMBOLS[None, :, :]
    nibble_cost = np.sum(diff * diff, axis=2)  # (S, 16)

    metrics = np.full(4, np.inf, np.float32)
    metrics[0] = 0.0
    backptr = np.zeros((s_steps, 4), np.uint8)
    for t in range(s_steps):
        cost = nibble_cost[t][OUTPUT_NIBBLE]  # (state, inp)
        cand = metrics[:, None] + cost
        backptr[t] = np.argmin(cand, axis=0)
        metrics = cand[backptr[t], np.arange(4)]
    end_state = int(np.argmin(metrics))
    states = np.empty(s_steps + 1, np.uint8)
    states[s_steps] = end_state
    for t in range(s_steps - 1, -1, -1):
        states[t] = backptr[t, states[t + 1]]
    return states[1:-1].copy(), float(metrics[end_state])


# ---------------------------------------------------------------------------
# 3/4-rate trellis (P25 confirmed data blocks, TIA-102.BAAA-A Annex E)
# ---------------------------------------------------------------------------
# 8-state trellis, state = previous input tribit; each input tribit emits a
# 4-bit constellation nibble (two transmitted dibits).  144 info bits become
# 48 tribits + 1 flush tribit -> 49 nibbles -> 196 bits (same on-air size as
# a 1/2-rate block).  Table per TIA-102.BAAA-A Annex E (spec constant; the
# reference carries the same matrix, reference ``dsp/fec/trellis.py:389``).

OUTPUT_NIBBLE_34 = np.array(
    [
        [2, 13, 14, 1, 7, 8, 11, 4],
        [14, 1, 7, 8, 11, 4, 2, 13],
        [10, 5, 6, 9, 15, 0, 3, 12],
        [6, 9, 15, 0, 3, 12, 10, 5],
        [15, 0, 3, 12, 10, 5, 6, 9],
        [3, 12, 10, 5, 6, 9, 15, 0],
        [7, 8, 11, 4, 2, 13, 14, 1],
        [11, 4, 2, 13, 14, 1, 7, 8],
    ],
    np.uint8,
)


def encode_tribits_34(tribits: np.ndarray) -> np.ndarray:
    """Encode input tribits (+ flush tribit 0) -> transmitted dibits."""
    state = 0
    tri = list(np.asarray(tribits, np.uint8)) + [0]
    out = np.empty(2 * len(tri), np.uint8)
    for i, t in enumerate(tri):
        nib = OUTPUT_NIBBLE_34[state, t]
        out[2 * i] = (nib >> 2) & 3
        out[2 * i + 1] = nib & 3
        state = int(t)
    return out


def encode_bits_34(bits144: np.ndarray) -> np.ndarray:
    """144 info bits -> 196 transmitted bits (with flush tribit)."""
    bits = np.asarray(bits144, np.uint8)
    tribits = (bits[0::3] << 2) | (bits[1::3] << 1) | bits[2::3]
    out_dibits = encode_tribits_34(tribits)
    out = np.empty(2 * len(out_dibits), np.uint8)
    out[0::2] = (out_dibits >> 1) & 1
    out[1::2] = out_dibits & 1
    return out


def viterbi_decode_dibits_34(rx_dibits: np.ndarray) -> tuple[np.ndarray, int]:
    """Viterbi over the 8-state 3/4 trellis -> (input tribits, error metric).

    ``rx_dibits`` has even length 2*S; returns S-1 data tribits (flush
    dropped) and the best-path metric (0 = clean).
    """
    rx = np.asarray(rx_dibits, np.uint8)
    s_steps = len(rx) // 2
    rx_nibbles = (rx[0::2].astype(np.int32) << 2) | rx[1::2].astype(np.int32)

    metrics = np.full(8, np.inf, np.float32)
    metrics[0] = 0.0
    backptr = np.zeros((s_steps, 8), np.uint8)
    for t in range(s_steps):
        cost = _DIST[OUTPUT_NIBBLE_34, rx_nibbles[t]]  # (state, inp)
        cand = metrics[:, None] + cost  # next state == inp
        backptr[t] = np.argmin(cand, axis=0)
        metrics = cand[backptr[t], np.arange(8)]

    end_state = int(np.argmin(metrics))
    err = float(metrics[end_state])
    states = np.empty(s_steps + 1, np.uint8)
    states[s_steps] = end_state
    for t in range(s_steps - 1, -1, -1):
        states[t] = backptr[t, states[t + 1]]
    return states[1:-1].copy(), int(err)


def viterbi_decode_bits_34(bits196: np.ndarray) -> tuple[np.ndarray, int]:
    """196 received bits -> (144 decoded info bits, error metric)."""
    bits = np.asarray(bits196, np.uint8)
    rx_dibits = (bits[0::2] << 1) | bits[1::2]
    tribits, err = viterbi_decode_dibits_34(rx_dibits)
    out = np.empty(3 * len(tribits), np.uint8)
    out[0::3] = (tribits >> 2) & 1
    out[1::3] = (tribits >> 1) & 1
    out[2::3] = tribits & 1
    return out, err


def viterbi_decode_soft_34(soft_pairs: np.ndarray) -> tuple[np.ndarray, float]:
    """Soft-decision 3/4 Viterbi over (S, 2) soft symbol pairs -> tribits."""
    rx = np.asarray(soft_pairs, np.float32)
    s_steps = rx.shape[0]
    diff = rx[:, None, :] - _NIBBLE_SYMBOLS[None, :, :]
    nibble_cost = np.sum(diff * diff, axis=2)  # (S, 16)

    metrics = np.full(8, np.inf, np.float32)
    metrics[0] = 0.0
    backptr = np.zeros((s_steps, 8), np.uint8)
    for t in range(s_steps):
        cost = nibble_cost[t][OUTPUT_NIBBLE_34]  # (state, inp)
        cand = metrics[:, None] + cost
        backptr[t] = np.argmin(cand, axis=0)
        metrics = cand[backptr[t], np.arange(8)]
    end_state = int(np.argmin(metrics))
    states = np.empty(s_steps + 1, np.uint8)
    states[s_steps] = end_state
    for t in range(s_steps - 1, -1, -1):
        states[t] = backptr[t, states[t + 1]]
    return states[1:-1].copy(), float(metrics[end_state])
