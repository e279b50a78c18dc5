"""The grouped expert GEMMs' (``torch._grouped_mm``, CUTLASS's grouped GEMM
on sm90, with its problem-setup kernels; forward and backward) roofline
bound over their device time in the traced steps, percent.  Every routed
row is computed, so a step issues a fixed number of them: two a routing
layer forward (gate|up, down) and four backward (each one's rows' and
weights' gradients); nothing where none ran."""

from benchmark.bounds_deepseek import expert_gemm_bound_s

GEMM, SETUP = "GroupProblemShape", "prepare_grouped_gemm_data"  # in the kernels' names


def read(run):
    t = run.trace
    if t is None or not t.extra.get("backward"):
        return None
    gemms = [(n, a, b) for n, a, b in t.launched if GEMM in n]
    if not gemms:
        return None
    m = run.cell.config["model"]
    c, batches = m["deepseek"], t.extra["forward_batches"]
    layers = c["num_hidden_layers"] - c["first_k_dense_replace"]
    if len(gemms) != 6 * layers * len(batches):
        raise RuntimeError(f"{len(gemms)} grouped GEMM records for {len(batches)} steps of "
                           f"{layers} expert layers (6 each)")
    tokens = (224 // m["vit_patch"]) ** 2 + 1
    args = (c["num_experts_per_tok"], c["n_routed_experts"], c["hidden_size"],
            c["moe_intermediate_size"])
    bound = layers * sum(expert_gemm_bound_s(b * tokens, *args, backward=False)
                         + expert_gemm_bound_s(b * tokens, *args, backward=True) for b in batches)
    spent = 1e-6 * sum(b - a for n, a, b in t.launched if GEMM in n or SETUP in n)
    return 100.0 * bound / spent
