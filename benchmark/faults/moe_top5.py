"""The router drops the sixth of its six experts: each token's last (the
smallest) choice gets weight 0, so every expert layer's output is its
top-5 experts' (on the card and the CPU alike)."""


def plant() -> None:
    import torch

    from guitar_tablature_classification_tpu_torch.ops import moe

    made = moe.route

    def route(*args, **kwargs):
        weights, ids, scores = made(*args, **kwargs)
        return torch.cat([weights[:, :-1], torch.zeros_like(weights[:, -1:])], dim=1), ids, scores

    moe.route = route
