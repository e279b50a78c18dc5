"""The MLA attention kernels' (B5 at widths 192/128, causal; forward and
backward) roofline bound over their device time in the traced steps,
percent.  The trace's records of each kernel are checked against the
launch counters ``attn_fwd_mla`` and ``attn_bwd_mla``; nothing where no
MLA kernel ran."""

from benchmark.bounds_deepseek import mla_bound_s

KERNELS = {"attn_fwd_mla": ("attn_fwd_mla_kernel",),
           "attn_bwd_mla": ("attn_rowdot_mla_kernel", "attn_bwd_kv_mla_kernel",
                            "attn_bwd_q_mla_kernel")}


def read(run):
    t = run.trace
    if t is None or not t.extra.get("backward") or not t.extra["counts"].get("attn_fwd_mla"):
        return None
    counts, batches = t.extra["counts"], t.extra["forward_batches"]
    got = {k: (t.kernel_count(k), counts.get(w, 0)) for w, ks in KERNELS.items() for k in ks}
    if any(a != b for a, b in got.values()):
        raise RuntimeError(f"the trace's MLA kernel records do not match the launch counters: "
                           f"{{kernel: (records, launches)}} {got}")
    m = run.cell.config["model"]
    c = m["deepseek"]
    layers = c["num_hidden_layers"]
    if counts["attn_fwd_mla"] != layers * len(batches) or counts["attn_bwd_mla"] != counts["attn_fwd_mla"]:
        raise RuntimeError(f"{counts} MLA launches for {len(batches)} steps of {layers} layers")
    tokens = (224 // m["vit_patch"]) ** 2 + 1
    dqk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    bound = layers * sum(mla_bound_s(k, b, tokens, c["num_attention_heads"], dqk, c["v_head_dim"])
                         for b in batches for k in KERNELS)
    spent = t.kernel_s(tuple(k for ks in KERNELS.values() for k in ks))
    return 100.0 * bound / spent
