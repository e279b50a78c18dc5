"""Synthesize a GuitarSet-shaped dataset tree (the JAX repo's
``tools/make_synthetic_guitarset.py``).

At its defaults it has the real dataset's scale: 360 excerpts, 180 track
ids x {comp, solo}, ~24 s each, ~43k non-overlapping 0.2 s windows, the
shape of the reference's 43,188-fixture payload (SURVEY C16), with the
shipped fixtures' label statistics (data/synthetic.py style="guitarset").

    python -m guitar_tablature_classification_tpu_torch.tools.make_synthetic_guitarset \\
        --out synthset [--excerpts 360] [--duration 24.0] [--seed 42]

writes {out}/audio/*.wav + {out}/annotation/*.jams, then:

    python -m guitar_tablature_classification_tpu_torch.tools.run_guitarset \\
        --audio synthset/audio --annotation synthset/annotation --workdir synthset/work
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="make-synthetic-guitarset")
    p.add_argument("--out", required=True)
    p.add_argument("--excerpts", type=int, default=360,
                   help="total excerpts (half comp, half solo ids)")
    p.add_argument("--duration", type=float, default=24.0,
                   help="seconds per excerpt (~43k windows at 360 x 24 s)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--hardness", type=float, default=0.0,
                   help="recording-condition corruption level 0..1 "
                        "(RenderConfig.hardness: noise, detune, "
                        "inharmonicity, pluck transients, bleed). Same "
                        "--seed => identical performances/JAMS/labels at "
                        "every level; only the audio rendering differs.")
    args = p.parse_args(argv)

    from scipy.io import wavfile

    from ..config import CQTConfig
    from ..data.synthetic import (
        RenderConfig,
        events_to_jams_dict,
        random_performance,
        render_performance,
    )

    cfg = CQTConfig()
    audio_dir = os.path.join(args.out, "audio")
    jams_dir = os.path.join(args.out, "annotation")
    os.makedirs(audio_dir, exist_ok=True)
    os.makedirs(jams_dir, exist_ok=True)

    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    n_windows = 0
    for i in range(args.excerpts):
        track_id = i // 2
        kind = "comp" if i % 2 == 0 else "solo"
        name = f"{track_id:02d}_Synth{track_id:03d}_{kind}"
        events = random_performance(rng, args.duration)
        audio = render_performance(
            events, args.duration, cfg, seed=i,
            render=RenderConfig.hardness(args.hardness),
        )
        # GuitarSet-style hex suffix exercises the WAV-probing logic
        wavfile.write(
            os.path.join(audio_dir, f"{name}_hex.wav"),
            cfg.sample_rate,
            (np.clip(audio, -1, 1) * 32767).astype(np.int16),
        )
        with open(os.path.join(jams_dir, f"{name}.jams"), "w") as f:
            json.dump(events_to_jams_dict(events, args.duration), f)
        n_windows += int(args.duration / cfg.window_seconds)
        if (i + 1) % 60 == 0:
            print(f"  {i + 1}/{args.excerpts} excerpts "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
    print(
        f"wrote {args.excerpts} excerpts (~{n_windows} windows) to "
        f"{args.out} in {time.perf_counter() - t0:.0f}s"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
