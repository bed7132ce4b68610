"""The operation and byte counts against counts made by hand at tiny shapes."""

import pytest

from helpers import BENCH  # noqa: F401  (puts the benchmark on the path)
import counts

CFG = {"vocab_size": 5, "num_classes": 2, "latent_dim": 3, "dtype": "bfloat16",
       "encoder": {"model_size": 4, "num_layers": 1, "num_heads": 2, "ffn_multiplier": 2},
       "decoder": {"model_size": 2, "num_layers": 2, "num_heads": 1, "ffn_multiplier": 4},
       "train": {"max_seq_len": 3}}


def test_dense_and_stacks():
    # D=4, FF=8: q, k, v, o 4*16 products a position, FFN 2*32: 128 MACs
    assert counts.dense_flops(CFG["encoder"]) == 2 * 128
    # n=3: 3 positions x 256 + attention 4*4*9, one layer, latent head 2*4*6
    assert counts.encoder_flops(CFG, 3) == 3 * 256 + 144 + 48
    # D=2, FF=8: 4*4 + 2*16 = 48 MACs a position; m=3: two layers of
    # 3*96 + 4*2*6, latent2hid 2*3*2, head 2*2*5 at 2 positions
    assert counts.decoder_flops(CFG, 3) == 12 + 2 * (3 * 96 + 48) + 40
    assert counts.train_step_flops(CFG, [2]) == 3 * (counts.encoder_flops(CFG, 2)
                                                     + counts.decoder_flops(CFG, 3))


def test_flash_pairs_and_bytes():
    assert counts.flash_pairs([3], 3, False, 2) == 2 * 9
    assert counts.flash_pairs([3, 1], 3, True, 1) == (1 + 2 + 3) + (1 + 1 + 1)
    fwd, bwd = counts.flash_bytes(1, 2, 1, 4, 2)
    qkv, ctx, lse = 1 * 2 * 1 * 3 * 4 * 2, 2 * 4 * 2, 2 * 4
    assert (fwd, bwd) == (qkv + ctx + lse + 4, 2 * qkv + 2 * ctx + lse + 4)


def test_bound_takes_the_largest_term():
    assert counts.bound_s(989e12, 0, "bfloat16") == pytest.approx(1.0)
    assert counts.bound_s(1, 3.35e12, "bfloat16") == pytest.approx(1.0)
    assert counts.bound_s(1, 1, "bfloat16", exps=3.9e12) == pytest.approx(1.0)
    assert counts.bound_s(495e12, 0, "float32") == pytest.approx(1.0)


def test_k1_bytes():
    # decoder D=2, FF=8, V=5, 2 layers, bf16: a layer 16+8+32+8+2+8 = 74
    # values; embeddings 10 + class rows 4; head 10 + 5 float32
    weights = (2 * 74 + 10 + 4) * 2 + 15 * 4
    assert counts.k1_bytes(CFG, rows=3, T=6) == weights + 3 * (2 * 2 + 6 * 4 + 4)


def test_flash_bound_of_a_step():
    cfg = dict(CFG, dtype="bfloat16")
    t = counts.flash_bound_s(cfg, [4], [5])
    enc_pairs, dec_pairs = 2 * 16, counts.flash_pairs([5], 5, True, 1)
    expect = (counts.bound_s(4 * 2 * enc_pairs, counts.flash_bytes(1, 4, 2, 2, 2)[0], "bfloat16",
                             enc_pairs)
              + counts.bound_s(10 * 2 * enc_pairs, counts.flash_bytes(1, 4, 2, 2, 2)[1],
                               "bfloat16", enc_pairs)
              + 2 * (counts.bound_s(4 * 2 * dec_pairs, counts.flash_bytes(1, 5, 1, 2, 2)[0],
                                    "bfloat16", dec_pairs)
                     + counts.bound_s(10 * 2 * dec_pairs, counts.flash_bytes(1, 5, 1, 2, 2)[1],
                                      "bfloat16", dec_pairs)))
    assert t == pytest.approx(expect)
