"""The yardstick's arithmetic against hand counts: the frozen kernel costs
(one paged int4 decode step, one dense one, one causal prefill) and the
model FLOPs of a decode token and of a prompt; and the program still
naming each kernel whose cost the frozen copy holds."""
from __future__ import annotations

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(os.path.dirname(HERE), "src")]

from pbench import clients, flops, kernel_cost, peaks, spec  # noqa: E402

CR = spec.model_keys(spec.config("command-r-35b"))
# ai21labs/Jamba-v0.1's published keys at 16 of its 32 layers: a hybrid
# of Mamba and attention mixers, MoE on every other layer
JB = {"model_type": "jamba", "hidden_size": 4096, "num_hidden_layers": 16,
      "num_attention_heads": 32, "num_key_value_heads": 8,
      "intermediate_size": 14336, "vocab_size": 65536,
      "attn_layer_period": 8, "attn_layer_offset": 4,
      "expert_layer_period": 2, "expert_layer_offset": 1,
      "num_experts": 16, "num_experts_per_tok": 2, "mamba_d_state": 16,
      "mamba_d_conv": 4, "mamba_expand": 2, "mamba_dt_rank": 256}


@pytest.mark.parametrize("name", ["paged_decode_attention_int4",
                                  "decode_attention", "flash_attention"])
def test_the_program_still_has_each_frozen_kernel(name):
    from repro_torch.kernels import cost
    assert name in cost.COSTS and callable(getattr(kernel_cost, name))


def test_paged_int4_decode_step_by_hand():
    # command-r: 8 KV heads x 128 = 1,024 values a token and layer, int4
    # groups of 128 (8 a token): K and V each 8 x (64 packed + 4 scale + 4
    # zero) bytes = 576, 1,152 a token; one slot at kv_len 1,000; q and
    # the output 8 x 8 x 128 bf16 each; the page table 256 int32 + kv_len
    per_layer_bytes = 1000 * 1152 + 2 * 8 * 8 * 128 * 2 + 4 * (256 + 1)
    per_layer_flops = 4 * 64 * 128 * 1000
    got = flops.decode_attention_bound_s(CR, [1000], paged_int4=True,
                                         page_size=16, max_seq=4096)
    want = 40 * max(per_layer_flops / peaks.BF16_FLOPS,
                    per_layer_bytes / peaks.HBM_BYTES_PER_S)
    assert got == pytest.approx(want, rel=1e-12)
    assert per_layer_bytes == 1_185_796


def test_dense_decode_step_by_hand():
    # the hybrid's 2 attention layers, bf16 K and V: 8 x 128 x 2 bytes each a
    # token; two slots at 100 and 300
    per_layer_bytes = 400 * 8 * 128 * 2 * 2 + 2 * (2 * 8 * 4 * 128 * 2) \
        + 4 * 2
    got = flops.decode_attention_bound_s(JB, [100, 300], paged_int4=False,
                                         page_size=16, max_seq=4096)
    assert got == pytest.approx(
        2 * per_layer_bytes / peaks.HBM_BYTES_PER_S, rel=1e-12)


def test_causal_prefill_by_hand():
    n = 1024
    pairs = n * (n + 1) // 2                       # 524,800
    fl = 4 * 128 * 64 * pairs                      # 17,196,646,400
    by = (2 * n * 64 * 128 + 2 * n * 8 * 128) * 2  # q, o, k, v in bf16
    assert (fl, by) == (17_196_646_400, 37_748_736)
    assert flops.prefill_attention_bound_s(CR, n) == pytest.approx(
        40 * max(fl / peaks.BF16_FLOPS, by / peaks.HBM_BYTES_PER_S))


def test_model_flops_by_hand():
    # command-r: a layer's q, k, v, o and SwiGLU products
    layer = 8192 * 8192 * 2 + 2 * 8192 * 1024 + 3 * 8192 * 22528
    assert flops.weights_per_token(CR) == 40 * layer == 28_185_722_880
    tok = 2 * 40 * layer + 2 * 8192 * 256000 + 4 * 128 * 64 * 1000 * 40
    assert flops.decode_flops(CR, [1000]) == pytest.approx(tok)
    pre = 10 * 2 * 40 * layer + 4 * 128 * 64 * 55 * 40 + 2 * 8192 * 256000
    assert flops.prefill_flops(CR, 10) == pytest.approx(pre)
    # the hybrid: 14 Mamba and 2 attention mixers, 8 dense and 8 MoE FFNs (the
    # router and the 2 experts a token meets)
    d, di, f = 4096, 8192, 14336
    mamba = d * 2 * di + di * (256 + 32) + 256 * di + di * d
    attn = d * d * 2 + 2 * d * 1024
    ffn = 8 * 3 * d * f + 8 * (d * 16 + 2 * 3 * d * f)
    assert flops.weights_per_token(JB) == 14 * mamba + 2 * attn + ffn


def test_decode_steps_stop_at_each_requests_end():
    c = clients.Call("decode", 0.0, rids=[1, 2], lens=[100, 7], left=[3, 9],
                     n_steps=4)
    assert flops.decode_step_lens(c, 4096) == [[101, 8], [102, 9],
                                               [103, 10], [11]]
