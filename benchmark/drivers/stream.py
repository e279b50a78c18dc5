"""Live transcription traffic: each track one session of a fresh
``StreamingTranscriber`` over one shared ``Transcriber``, closed loop.

Set-up is the serving driver's (the Transcriber with the seed's weights,
``batch_size`` and ``buckets``, the tracks of ``track_seconds``, each
streamed once, which warms every bucket shape the sessions use).  A
session feeds its track in chunks of ``chunk_seconds`` taken in a fixed
cycle from the track's start, each chunk sent after the last ``feed``
returned, then calls ``flush``.  The Transcriber's ``predict_windows`` is
wrapped so that a session's output carries the logits its windows got,
and the serving check compares the session's whole output (frets and
logits) with the reference's logits of the track.  The window record adds
to the serving driver's the latency of every ``feed`` of the window, from
the call to its return (``chunk_s``)."""

from __future__ import annotations

import time

import numpy as np

from . import serve


class Driver(serve.Driver):
    def setup(self) -> None:
        self.chunk_latency: list[float] = []
        super().setup()
        cfg = self.transcriber.cqt_cfg
        if cfg.hop_samples != self.hop:
            raise ValueError(f"the stream's hop is the CQT configuration's ({cfg.hop_samples} "
                             f"samples), the traffic asks for {self.hop}")
        self.chunk_latency.clear()

    def _record_logits(self) -> list:
        """Wrap the Transcriber's ``predict_windows`` (once): its logits
        are appended to the list returned, which each session empties."""
        if getattr(self, "_logits", None) is None:
            self._logits = []
            predict = self.transcriber.predict_windows

            def recorded(windows):
                out = predict(windows)
                self._logits.append(out)
                return out

            self.transcriber.predict_windows = recorded
        self._logits.clear()
        return self._logits

    def _transcribe(self):
        from guitar_tablature_classification_tpu_torch.infer.streaming import StreamingTranscriber
        from guitar_tablature_classification_tpu_torch.infer.transcribe import Transcription

        i = self.sent % len(self.tracks)
        self.sent += 1
        track, sr = self.tracks[i], self.transcriber.cqt_cfg.sample_rate
        sizes = [int(s * sr) for s in self.traffic["chunk_seconds"]]
        logits = self._record_logits()
        session = StreamingTranscriber(self.transcriber, smooth_window=self.traffic["smooth_window"])
        frets, lo, k = [], 0, 0
        with self.spans("transcribe"):
            while lo < len(track):
                hi = min(len(track), lo + sizes[k % len(sizes)])
                t = time.perf_counter()
                frets.append(session.feed(track[lo:hi]).frets)
                self.chunk_latency.append(time.perf_counter() - t)
                lo, k = hi, k + 1
            frets.append(session.flush().frets)
        out = Transcription(frets=np.concatenate(frets), times=np.zeros(0),
                            logits=np.concatenate(logits) if logits else np.zeros((0, 6, 19)))
        return i, out

    def window(self, seconds: float) -> dict:
        self.chunk_latency.clear()
        out = super().window(seconds)
        out["chunk_s"] = list(self.chunk_latency)
        return out
