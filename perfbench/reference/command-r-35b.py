"""Plain reference of command-r-35b (Cohere Command R: a dense decoder of
parallel blocks), float32.

Each layer: ``h = LayerNorm(x)``; ``x = x + Attention(h) + MLP(h)``, the
attention grouped-query and causal with rotary positions, the MLP SwiGLU;
a final LayerNorm, then logits against the tied embedding table times
``logit_scale``. Departures from the published model, which the program
shares: rotary embedding on the two halves of each head rather than on
interleaved pairs (with random weights the two differ only by a fixed
permutation of ``wq``'s and ``wk``'s columns), and ``logit_scale`` as the
configuration file states it.
"""
from __future__ import annotations

import torch

from reference import plain


def logits_many(m: dict, params: dict, items, *, fp8: bool = False):
    """f32 logits of several independent sequences in one batched forward:
    ``items`` are ``(tokens, prompt_len, n_read)``; for each, the logits
    ``(n_read, V)`` at positions ``prompt_len - 1 .. prompt_len - 2 +
    n_read``, each predicting the token after it. Rows are padded at
    their ends, which a causal model never reads back."""
    prec = plain.Prec(fp8)
    eps = float(m["layer_norm_eps"])
    H, Hkv = m["num_attention_heads"], m["num_key_value_heads"]
    hd = m["hidden_size"] // H
    dev = params["embed"].device
    T = max(len(s) for s, _, _ in items)
    tok = torch.zeros(len(items), T, dtype=torch.long, device=dev)
    for i, (s, _, _) in enumerate(items):
        tok[i, :len(s)] = torch.as_tensor(s, dtype=torch.long, device=dev)
    with plain.exact(), torch.no_grad():
        x = params["embed"][tok].float()
        B = x.shape[0]
        for p in params["layers"]:
            h = plain.layernorm(x, p["norm1"]["scale"], p["norm1"]["bias"],
                                eps)
            a = p["attn"]
            q = prec.mm(h, a["wq"]).view(B, T, H, hd)
            k = prec.mm(h, a["wk"]).view(B, T, Hkv, hd)
            v = prec.mm(h, a["wv"]).view(B, T, Hkv, hd)
            q, k = plain.rope(q, m["rope_theta"]), plain.rope(k,
                                                            m["rope_theta"])
            o = plain.causal_attention(q, k, v).reshape(B, T, H * hd)
            mlp = plain.gated_mlp(h, p["mlp"]["wi"], p["mlp"]["wo"], prec)
            x = x + prec.mm(o, a["wo"]) + mlp
            del h, q, k, v, o, mlp
        rows = torch.cat([x[i, n - 1:n - 1 + k]
                          for i, (_, n, k) in enumerate(items)])
        fn = params["final_norm"]
        hN = plain.layernorm(rows, fn["scale"], fn["bias"], eps)
        out = plain.unembed(hN, params["embed"], True, prec,
                            float(m["logit_scale"]))
        return list(torch.split(out, [k for _, _, k in items]))

