"""poreplex_torch.dashboard against poreplex_tpu.dashboard: the alias table,
the mapping statistics, the progress bars, the two rates and the pure
renderer over a few session states at several widths and heights give the
same values and the same text in both packages. Also DashboardView's
snapshot of a session and its curses layer on a stand-in ``curses``
(``install_curses``, which the whole-session tests use too)."""

import sys
import types
from collections import defaultdict

import pytest

from poreplex_tpu import dashboard as jax_dashboard
from poreplex_torch import dashboard

FEEDS = (
    {'mapped': {0: ['NC_0001', 'NC_0001', 'chrM'], None: ['chrX|alt']},
     'failed': {0: 2}, 'unmapped': {0: 1}},
    {'mapped': {None: ['chrX|alt', 'NC_0002']}, 'unmapped': {3: 4}},
    {'failed': {None: 5}},
)
ALIASES = 'NC_0001\tchr1\nNC_0002\tchr2\nbroken-line\n'


def statistics(module, tmp_path):
    path = tmp_path / (module.__name__ + '.txt')
    path.write_text(ALIASES)
    stats = module.ReadMappingStatistics(module.load_aliases(str(path)))
    for feed in FEEDS:
        stats.feed(feed)
    return stats


def test_aliases_and_statistics(tmp_path):
    ref = statistics(jax_dashboard, tmp_path)
    got = statistics(dashboard, tmp_path)
    assert got.aliases == ref.aliases == {'NC_0001': 'chr1',
                                          'NC_0002': 'chr2'}
    for name in ('total', 'failed', 'unmapped'):
        assert dict(getattr(got, name)) == dict(getattr(ref, name)), name
    assert {k: dict(v) for k, v in got.counts.items()} == \
        {k: dict(v) for k, v in ref.counts.items()}
    assert got.groups() == ref.groups() == [0, 3, None]
    for group in got.groups():
        for limit in (1, 2, 50):
            assert got.top_contigs(group, limit) == \
                ref.top_contigs(group, limit)
    assert dashboard.mapped_rate(got) == jax_dashboard.mapped_rate(ref)


@pytest.mark.parametrize('width', [4, 12, 30, 80])
def test_format_bar(width):
    for label in ('progress   ', 'x', 'mapped     '):
        for fraction in (-0.2, 0.0, 0.333, 0.5, 0.999, 1.0, 1.7):
            assert dashboard.format_bar(label, fraction, width) == \
                jax_dashboard.format_bar(label, fraction, width)


def test_demux_rate():
    counts = defaultdict(int, {('pass', 0, 'okay'): 5,
                               ('pass', None, 'okay'): 3,
                               ('fail', 2, 'adapter_not_detected'): 2})
    for tracker in (counts, {}):
        assert dashboard.demux_rate(tracker) == \
            jax_dashboard.demux_rate(tracker)
    assert dashboard.demux_rate(counts) == (0.7, 10)


STATES = (
    dict(elapsed_s=0.4, reads_found=0, reads_processed=0, reads_queued=0,
         scan_finished=False, rate_label='mapped', rate_fraction=0.0,
         group_name='undetermined', mapped=0, unmapped=0, failed=0,
         top_contigs=[]),
    dict(elapsed_s=3725.9, reads_found=512, reads_processed=256,
         reads_queued=256, scan_finished=True, rate_label='mapped',
         rate_fraction=0.8125, group_name='BC1', mapped=208, unmapped=40,
         failed=8,
         top_contigs=[('chr{}'.format(i), 60 - i) for i in range(40)]),
    dict(elapsed_s=90061.0, reads_found=7, reads_processed=9,
         reads_queued=-2, scan_finished=True, rate_label='demuxed',
         rate_fraction=1.0, group_name='None', mapped=1, unmapped=0,
         failed=0, top_contigs=[('a-very-long-contig-name|with|bars', 1)]),
)


@pytest.mark.parametrize('state', range(len(STATES)))
@pytest.mark.parametrize('width,height', [(20, 5), (40, 12), (79, 24),
                                          (132, 60)])
def test_render_dashboard(state, width, height):
    rows = dashboard.render_dashboard(STATES[state], width, height)
    assert rows == jax_dashboard.render_dashboard(STATES[state], width,
                                                  height)
    assert len(rows) <= height
    assert all(len(row) <= width for row in rows)


class Screen:
    """A stand-in curses window: keys to return, rows drawn."""

    def __init__(self, keys=()):
        self.keys = list(keys)
        self.drawn = []

    def nodelay(self, flag):
        pass

    def keypad(self, flag):
        pass

    def getch(self):
        return self.keys.pop(0) if self.keys else -1

    def erase(self):
        self.drawn = []

    def getmaxyx(self):
        return 24, 80

    def addnstr(self, y, x, text, n, attr):
        self.drawn.append((y, text[:n], attr))

    def refresh(self):
        pass


def make_curses(screen):
    calls = []

    def record(name):
        return lambda *args: calls.append(name)
    curses = types.SimpleNamespace(
        initscr=lambda: screen, noecho=record('noecho'),
        cbreak=record('cbreak'), nocbreak=record('nocbreak'),
        echo=record('echo'), endwin=record('endwin'), KEY_LEFT=260,
        KEY_RIGHT=261, A_REVERSE=1 << 18)
    curses.calls = calls
    return curses


def install_curses(monkeypatch, keys=()):
    """A stand-in curses in sys.modules; returns it (``.calls`` lists the
    terminal calls) and its screen."""
    screen = Screen(keys)
    curses = make_curses(screen)
    monkeypatch.setitem(sys.modules, 'curses', curses)
    return curses, screen


class Session:
    def __init__(self):
        self.reads_found = 12
        self.reads_processed = 9
        self.reads_queued = 3
        self.scan_finished = False
        tracker = types.SimpleNamespace(counts=defaultdict(int, {
            ('pass', 0, 'okay'): 6, ('fail', None, 'okay'): 3}))
        self.finalsummary_tracker = tracker
        self.stopped = []

    def stop(self, why):
        self.stopped.append(why)


@pytest.mark.parametrize('will_align', [True, False])
def test_view_on_a_stand_in_terminal(will_align, monkeypatch):
    """start, the keys (right twice, left, q), a draw and stop, on both
    packages' views: the same rows, the same terminal calls, the group
    selector clamped to the groups seen, q stopping the session."""
    seen = []
    for module in (jax_dashboard, dashboard):
        curses, screen = install_curses(monkeypatch, keys=[261, 261, 260,
                                                           ord('q')])
        session = Session()
        monkeypatch.setattr(module, 'time',
                            types.SimpleNamespace(time=lambda: 1000.0))
        view = module.DashboardView(session, {None: 'undetermined',
                                              0: 'BC1'}, 'progress',
                                    'mapped_rate', 0, {'NC_0001': 'chr1'})
        view.started_at -= 61.5
        for feed in FEEDS:
            view.feed_mapped(feed)

        class Loop:
            def create_task(self, coro):
                coro.close()
        view.start(Loop(), will_align)
        view._handle_keys()
        view._draw()
        view.stop()
        view.stop()
        seen.append((screen.drawn, curses.calls, session.stopped,
                     view.rate_stat, view.selected_group))
    assert seen[0] == seen[1]
    drawn, calls, stopped, rate_stat, group = seen[1]
    assert calls == ['noecho', 'cbreak', 'nocbreak', 'echo', 'endwin']
    assert stopped == ['USER']
    assert rate_stat == ('mapped_rate' if will_align else 'demux_rate')
    assert group == 1
    assert drawn[0][2] == 1 << 18 and 'elapsed 00:01:01' in drawn[0][1]
