"""B5's backward returns nothing: ``attention_cuda.bwd`` gives zero dq, dk
and dv, so the query, key and value projections get no gradient and the
blocks under each get only the residual's (the card only: the CPU runs the
plain attention)."""


def plant() -> None:
    from guitar_tablature_classification_tpu_torch.ops import attention_cuda

    made = attention_cuda.bwd

    def bwd(*args):
        return tuple(t.zero_() for t in made(*args))

    attention_cuda.bwd = bwd
