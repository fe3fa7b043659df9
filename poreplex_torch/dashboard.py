"""Full-screen terminal dashboard (``--dashboard``, with ``--align``).

The port's copy of poreplex-tpu's ``dashboard.py``, on the standard
library's ``curses`` (imported only in ``DashboardView.start``). The
screen is made by a pure function of a snapshot of the session,
``render_dashboard``, so its layout is tested without a terminal. The
alignment writer's tallies reach it through ``feed_mapped``.

It shows the elapsed time, the reads found, processed and queued, two
progress bars (progress, and the mapped or demultiplexed share), a group
selector over the barcodes with each group's mapped, unmapped and failed
reads, and the 50 contigs with the most reads, with aliases; q quits.
"""

import asyncio
import time
from collections import defaultdict


def load_aliases(filename):
    """A tab-separated table: contig, then the name to show."""
    aliases = {}
    with open(filename) as f:
        for line in f:
            fields = line.rstrip('\n').split('\t')
            if len(fields) >= 2:
                aliases[fields[0]] = fields[1]
    return aliases


class ReadMappingStatistics:
    """Mapped-contig counts and unmapped and failed reads, per group."""

    def __init__(self, aliases=None):
        self.aliases = aliases or {}
        self.counts = defaultdict(lambda: defaultdict(int))
        self.total = defaultdict(int)
        self.failed = defaultdict(int)
        self.unmapped = defaultdict(int)

    def feed(self, rescounts):
        for group, contigs in rescounts.get('mapped', {}).items():
            for contig in contigs:
                contig = self.aliases.get(contig, contig)
                self.counts[group][contig] += 1
                self.total[group] += 1
        for group, n in rescounts.get('failed', {}).items():
            self.failed[group] += n
        for group, n in rescounts.get('unmapped', {}).items():
            self.unmapped[group] += n

    def top_contigs(self, group, limit=50):
        items = sorted(self.counts[group].items(),
                       key=lambda kv: (-kv[1], kv[0]))
        return items[:limit]

    def groups(self):
        keys = (set(self.counts) | set(self.failed) | set(self.unmapped))
        return sorted(keys, key=lambda k: (k is None, k))


# --------------------------------------------------------------- rendering

def format_bar(label, fraction, width):
    """One progress-bar row: ``label [#####.....]  42.0%``."""
    fraction = min(1.0, max(0.0, fraction))
    pct = '{:6.1f}%'.format(100.0 * fraction)
    inner = max(4, width - len(label) - len(pct) - 4)
    filled = int(round(inner * fraction))
    return '{} [{}{}] {}'.format(label, '#' * filled,
                                 '.' * (inner - filled), pct)


def demux_rate(tracker_counts):
    """(share of the counted reads given a barcode, reads counted);
    ``tracker_counts`` is FinalSummaryTracker.counts, keyed by (label,
    barcode, status)."""
    total = barcoded = 0
    for (label, barcode, status), n in tracker_counts.items():
        total += n
        if barcode is not None:
            barcoded += n
    return (barcoded / total) if total else 0.0, total


def mapped_rate(stats):
    """(share of the aligner's reads that mapped, reads it saw)."""
    mapped = sum(stats.total.values())
    other = sum(stats.unmapped.values()) + sum(stats.failed.values())
    denom = mapped + other
    return (mapped / denom) if denom else 0.0, denom


def render_dashboard(state, width, height):
    """The screen's rows (each at most ``width`` characters, at most
    ``height`` rows) for a snapshot from DashboardView.snapshot_state;
    row 0 is the header, which the curses layer paints reversed. The
    header names Poreplex-TPU, as poreplex-tpu's does, so that both
    packages draw the same screen."""
    rows = []
    elapsed = int(state['elapsed_s'])
    header = (' Poreplex-TPU   elapsed {:02d}:{:02d}:{:02d}   '
              'found {}  processed {}  queued {} '.format(
                  elapsed // 3600, elapsed // 60 % 60, elapsed % 60,
                  state['reads_found'], state['reads_processed'],
                  state['reads_queued']))
    rows.append(header[:width])

    found = max(1, state['reads_found'])
    progress = state['reads_processed'] / found
    suffix = '' if state['scan_finished'] else '  (scanning)'
    rows.append((format_bar('progress   ', progress,
                            width - len(suffix)) + suffix)[:width])
    rows.append(format_bar(
        '{:<11s}'.format(state['rate_label']), state['rate_fraction'],
        width)[:width])
    rows.append('')

    rows.append('Group: {}   (</> to switch, q to quit)'.format(
        state['group_name'])[:width])
    rows.append('mapped {}  unmapped {}  failed {}'.format(
        state['mapped'], state['unmapped'], state['failed'])[:width])
    rows.append('')
    rows.append('Top mapped contigs:'[:width])
    for contig, cnt in state['top_contigs'][:max(0, height - len(rows))]:
        rows.append('  {:8d}  {}'.format(cnt, contig)[:width])
    return rows[:height]


class DashboardView:
    """The dashboard of a running session: reads its counters
    (``reads_found``, ``reads_processed``, ``reads_queued``,
    ``scan_finished``, ``finalsummary_tracker``), redraws twice a second
    on the session's loop and stops it on q."""

    def __init__(self, session, barcode_names, progress_stat, rate_stat,
                 analysis_delay, aliases):
        self.session = session
        self.barcode_names = barcode_names
        self.analysis_delay = analysis_delay
        self.rate_stat = rate_stat          # 'mapped_rate' | 'demux_rate'
        self.stats = ReadMappingStatistics(aliases)
        self.started_at = time.time()
        self.selected_group = 0
        self._screen = None
        self._task = None
        self._stopped = False

    # ------------------------------------------------------------------
    def start(self, loop, will_align):
        import curses
        if not will_align:
            self.rate_stat = 'demux_rate'
        self._curses = curses
        self._screen = curses.initscr()
        curses.noecho()
        curses.cbreak()
        self._screen.nodelay(True)
        self._screen.keypad(True)
        self._task = loop.create_task(self._update_loop())

    def stop(self):
        if self._stopped:
            return
        self._stopped = True
        if self._task is not None:
            self._task.cancel()
        if self._screen is not None:
            curses = self._curses
            curses.nocbreak()
            self._screen.keypad(False)
            curses.echo()
            curses.endwin()
            self._screen = None

    def feed_mapped(self, rescounts):
        self.stats.feed(rescounts)

    # ------------------------------------------------------------------
    async def _update_loop(self):
        try:
            while not self._stopped:
                self._handle_keys()
                self._draw()
                await asyncio.sleep(0.5)
        except asyncio.CancelledError:
            pass

    def _handle_keys(self):
        ch = self._screen.getch()
        while ch != -1:
            if ch in (ord('q'), ord('Q')):
                self.session.stop('USER')
            elif ch == self._curses.KEY_LEFT:
                self.selected_group = max(0, self.selected_group - 1)
            elif ch == self._curses.KEY_RIGHT:
                self.selected_group += 1
            ch = self._screen.getch()

    def snapshot_state(self, max_contigs=50):
        """What render_dashboard draws, from the live session; clamps the
        group selector to the groups seen."""
        sess = self.session
        groups = self.stats.groups() or [None]
        self.selected_group = min(self.selected_group, len(groups) - 1)
        group = groups[self.selected_group]

        if self.rate_stat == 'mapped_rate':
            rate, _ = mapped_rate(self.stats)
            rate_label = 'mapped'
        else:
            rate, _ = demux_rate(sess.finalsummary_tracker.counts)
            rate_label = 'demuxed'

        return {
            'elapsed_s': time.time() - self.started_at,
            'reads_found': sess.reads_found,
            'reads_processed': sess.reads_processed,
            'reads_queued': sess.reads_queued,
            'scan_finished': sess.scan_finished,
            'rate_label': rate_label,
            'rate_fraction': rate,
            'group_name': self.barcode_names.get(group, str(group)),
            'mapped': self.stats.total[group],
            'unmapped': self.stats.unmapped[group],
            'failed': self.stats.failed[group],
            'top_contigs': self.stats.top_contigs(group, max_contigs),
        }

    def _draw(self):
        scr = self._screen
        scr.erase()
        maxy, maxx = scr.getmaxyx()
        rows = render_dashboard(self.snapshot_state(), maxx - 1, maxy)
        for y, row in enumerate(rows):
            attr = self._curses.A_REVERSE if y == 0 else 0
            text = row.ljust(maxx - 1) if y == 0 else row
            scr.addnstr(y, 0, text, maxx - 1, attr)
        scr.refresh()
