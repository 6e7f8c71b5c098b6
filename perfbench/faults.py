"""Faults planted under a run's timed path, each as a ``program_hook`` for
``run.main``: the run must then come out not correct.  Used by the tests
(on the CPU, at small sizes) and by ``calibrate.py`` (on the card, at the
cell's size) to read what each fault scores."""
from __future__ import annotations

import dataclasses


def hidden_unchanged(prog, render, denoise):
    """The recurrent step hands back the hidden state it was given."""
    def d(gbuffer, hidden):
        y, _ = denoise(gbuffer, hidden)
        return y, hidden
    return render, d


def gbuffer_altered(prog, render, denoise):
    """The first hit's distance 0.1% long where the render produces it."""
    def r(phi):
        g = render(phi).clone()
        g[6] *= 1.001
        return g
    return r, denoise


def frame_altered(prog, render, denoise):
    """The denoised frame 10% bright where the denoiser produces it."""
    def d(gbuffer, hidden):
        y, h = denoise(gbuffer, hidden)
        return y * 1.1, h
    return render, d


def state_unchanged(prog, feed, step):
    """The optimiser step hands back the state it was given."""
    def s(state, x, y):
        new, metrics = step(state, x, y)
        return dataclasses.replace(state, step=new.step), metrics
    return feed, s


def half_batch(prog, feed, step):
    """Half of each batch left out, the loss the mean over the rest."""
    def s(state, x, y):
        n = x.shape[1] // 2
        return step(state, x[:, :n], y[:, :n])
    return feed, s


BY_LOOP = {"interactive": ("hidden_unchanged", "gbuffer_altered", "frame_altered"),
           "train": ("state_unchanged", "half_batch")}
