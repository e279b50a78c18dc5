"""B1's ``default`` tier writes each bin's features one bin up (an
off-by-one in the output's bin index): bin b + 1 gets bin b's row, bin 0
the gate floor, so every note reads a semitone high.  It breaks
``cqt_cuda.cqt_fused`` where its output is made, at the ``default`` tier
only (the ``native-best`` recipe's; the CPU's plain version goes through
the same wrapper)."""


def plant() -> None:
    from guitar_tablature_classification_tpu_torch.ops import cqt_cuda

    made = cqt_cuda.cqt_fused

    def cqt_fused(x, frontend, route=None):
        out = made(x, frontend, route)
        if frontend.cfg.precision == "default":
            out[:, 1:] = out[:, :-1].clone()
            out[:, 0] = frontend.cfg.gate_floor_db
        return out

    cqt_cuda.cqt_fused = cqt_fused
