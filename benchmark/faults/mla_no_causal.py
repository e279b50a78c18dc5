"""The latent attention drops its causal mask: every token attends to
every other, the readout token as before, the patch tokens to the future
(the MLA kernels on the card, the plain version on the CPU)."""


def plant() -> None:
    from guitar_tablature_classification_tpu_torch.models import deepseek_v2

    made = deepseek_v2.fused_attention

    def attend(q, k, v, *, scale=None, causal=False):
        return made(q, k, v, scale=scale, causal=False)

    deepseek_v2.fused_attention = attend
