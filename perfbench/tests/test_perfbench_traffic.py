"""The frozen traffic generators: one seed, one set of files."""

import numpy as np
import torch

from perfbench.traffic import files, synth

SPEC = {"length_seed": 0, "groups": [{"count": 3, "seconds": 2},
                                     {"count": 4, "log_uniform_s": [1, 5]}]}


def test_synth_copy_is_the_ports_generator():
    from audioyolo_tpu_torch.utils.synth_audio import synth_event_clips

    np.testing.assert_array_equal(synth.synth_event_clips(3, 8000, 12.0, seed=11),
                                  synth_event_clips(3, 8000, 12.0, seed=11))


def test_same_seed_same_files(tmp_path):
    a = files.audio(files.lengths(SPEC, 9, 8000), 9, 8000, "cpu")
    b = files.audio(files.lengths(SPEC, 9, 8000), 9, 8000, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    paths = files.write_dir(str(tmp_path), a, 8000)
    for p, x in zip(paths, a):
        np.testing.assert_array_equal(files.read_pcm16(p, 0, x.size + 5)[: x.size], x)
        from audioyolo_tpu_torch.data.wavio import read_wav_info

        assert read_wav_info(p)[:2] == (8000, x.size)


def test_seeds_share_sizes_in_another_order():
    a, b = files.lengths(SPEC, 1, 8000), files.lengths(SPEC, 2 ** 33 + 1, 8000)
    assert sorted(a) == sorted(b) and a != b
    assert files.audio(a[:1], 1, 8000, "cpu")[0].size == a[0]


def test_render_puts_events_where_the_layout_says():
    rng = np.random.default_rng(3)
    events = synth.event_layout(rng, 60.0)
    g = torch.Generator().manual_seed(1)
    x = synth.render(8000 * 60, events, 8000, g, "cpu")
    s, e, _ = events[0]
    inside = x[int(s * 8000) + 10: int(e * 8000) - 10].abs().mean()
    before = x[: int(s * 8000) - 10].abs().mean()
    assert inside > 10 * before
