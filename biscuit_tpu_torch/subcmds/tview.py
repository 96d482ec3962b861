"""biscuit tview port (src/tview.c): text alignment viewer.

All four reference color modes (tview.c:130-133,346-371,505-511):
  t  bisulfite (default): retention RED, conversion BLUE, other mismatch
     YELLOW; reference C/G colored, CpG cytosines RED+underline
  m  mapping quality: read-level pair 1-4 = mapq/10+1 clamped
  b  base quality: per-base pair 1-4 = baseq/10+1 clamped
  n  nucleotide: pair = base int + 5 (A green, C cyan, G magenta, T red)
Read-level underline for improper pairs / secondary (tview.c:516-518),
A_REVERSE for the -n highlighted read name, 's' short-format and 'r'
read-name row modes, and the reference's pop-up help window
(tview.c:537-585).

Interactive curses UI plus a non-interactive -d dump mode for headless
use; -d with -c also emits per-cell attribute lines (golden-testable):
digit = color pair 0-9, letter A-J = same pair underlined.

Copy of biscuit_tpu/subcmds/tview.py with only this docstring changed: its
imports are relative, and resolve to the port's own modules. curses is
imported only inside curses_view, which alone draws on a terminal, as in the
source. tests/test_torch_engine.py holds the copy to its source.
"""
import getopt
import sys
from typing import List, Optional, Tuple

from ..io.sambam import (AlignmentFile, AlnRecord, FLAG_PAIRED, FLAG_PROPER,
                         FLAG_REVERSE, FLAG_SECONDARY, FLAG_UNMAP)
from ..pileup.common import RefCache, get_bsstrand

TV_COLOR_MAPQ = 0      # tview.c:130
TV_COLOR_BASEQ = 1
TV_COLOR_NUCL = 2
TV_COLOR_BSMODE = 3

# attr encoding: low nibble = curses color pair (0-9, reference
# tview.c:140-148), bit 4 = underline, bit 5 = reverse video
A_UNDER = 16
A_REV = 32

NT_INT = {"A": 0, "C": 1, "G": 2, "T": 3}  # nt256char_to_nt256int8


class ReadRow:
    def __init__(self, rec: AlnRecord, bss: int):
        self.rec = rec
        self.bss = bss
        self.end = rec.pos + rec.rlen()


def _layout(reads: List[ReadRow]) -> List[List[ReadRow]]:
    rows: List[List[ReadRow]] = []
    ends: List[int] = []
    for r in sorted(reads, key=lambda x: x.rec.pos):
        placed = False
        for i, e in enumerate(ends):
            if r.rec.pos > e + 1:
                rows[i].append(r)
                ends[i] = r.end
                placed = True
                break
        if not placed:
            rows.append([r])
            ends.append(r.end)
    return rows


def _read_attr(rec: AlnRecord, color_for: int, hl_name: Optional[str]) -> int:
    """Read-level attribute (tview.c:503-519)."""
    attr = 0
    if color_for == TV_COLOR_MAPQ:
        attr |= min(rec.mapq // 10 + 1, 4)
    if hl_name is not None and rec.qname == hl_name:
        attr |= A_REV
    if ((rec.flag & FLAG_PAIRED) and not (rec.flag & FLAG_PROPER)) \
            or (rec.flag & FLAG_SECONDARY):
        attr |= A_UNDER
    return attr


def _render_read(r: ReadRow, left: int, width: int, rs: RefCache,
                 color_for: int, is_dot: bool, readattr: int):
    """(col, char, attr) cells for the visible window (tview.c:326-407)."""
    rec = r.rec
    out = []
    rpos = rec.pos + 1  # 1-based
    qpos = 0
    rev = bool(rec.flag & FLAG_REVERSE)
    seq = rec.seq
    qual = rec.qual
    for op, oplen in rec.cigar:
        if op in (0, 7, 8):
            for j in range(oplen):
                col = rpos + j - left
                if col < 0 or col >= width:
                    continue
                qb = (seq[qpos + j] if qpos + j < len(seq) else "N").upper()
                rb = rs.getbase_upcase(rpos + j)
                attr = readattr
                if color_for == TV_COLOR_BSMODE:
                    isconv = False
                    if rb == "G" and r.bss == 1:
                        if qb == "G":
                            attr |= 8                     # RED retention
                        elif qb == "A":
                            attr |= 1                     # BLUE conversion
                            isconv = True
                    elif rb == "C" and r.bss == 0:
                        if qb == "C":
                            attr |= 8
                        elif qb == "T":
                            attr |= 1
                            isconv = True
                    if not isconv and qb != rb and not (attr & 15):
                        attr |= 3                         # YELLOW mismatch
                elif color_for == TV_COLOR_NUCL:
                    attr |= NT_INT.get(qb, 4) + 5
                elif color_for == TV_COLOR_BASEQ:
                    x = ((ord(qual[qpos + j]) - 33) // 10 + 1
                         if qpos + j < len(qual) and qual != "*" else 1)
                    attr |= min(x, 4)
                # dot view exempts bisulfite-queried cytosines
                exempt = (color_for == TV_COLOR_BSMODE
                          and ((r.bss == 0 and rb == "C")
                               or (r.bss == 1 and rb == "G")))
                if is_dot and qb == rb and not exempt:
                    ch = "," if rev else "."
                else:
                    ch = qb.upper() if rev else qb.lower()
                out.append((col, ch, attr))
            rpos += oplen
            qpos += oplen
        elif op == 1 or op == 4:
            qpos += oplen
        elif op == 2:
            for j in range(oplen):
                col = rpos + j - left
                if 0 <= col < width:
                    out.append((col, "*", readattr))
            rpos += oplen
        elif op == 5:
            pass
    return out


def _short_format(hdr, rec: AlnRecord) -> str:
    """sam_short_format1 (tview.c:410-440)."""
    chrm = hdr.names[rec.tid] if rec.tid >= 0 else "*"
    if rec.mtid < 0:
        mchr = "*"
    elif rec.mtid == rec.tid:
        mchr = "="
    else:
        mchr = hdr.names[rec.mtid]
    return (f"{rec.flag}|{chrm}|{rec.pos + 1}|{rec.mapq}|"
            f"{rec.cigar_str()}|{mchr}|{rec.mpos + 1}|{rec.tlen}|")


def _ref_attrs(ref_line: str, color_for: int) -> List[int]:
    """Reference-row coloring (tview.c:460-480): nucleotide pairs in NUCL
    mode; in BSMODE CpG cytosines RED+underline, other C/G BLUE."""
    n = len(ref_line)
    attrs = [0] * n
    for i, c in enumerate(ref_line):
        if color_for == TV_COLOR_NUCL:
            attrs[i] = NT_INT.get(c, 4) + 5
        elif color_for == TV_COLOR_BSMODE:
            if c == "C":
                attrs[i] = (8 | A_UNDER) if (i + 1 < n and
                                             ref_line[i + 1] == "G") else 1
            elif c == "G":
                attrs[i] = (8 | A_UNDER) if (i > 0 and
                                             ref_line[i - 1] == "C") else 1
    return attrs


def _window(bam, rs, hdr, tid, left, width, color_for=TV_COLOR_BSMODE,
            is_dot=True, min_mapq=0, hl_name=None, show=0):
    """show: 0 bases, 1 short format, 2 read name (keys s/r)."""
    chrm = hdr.names[tid]
    rs.fetch(chrm, max(1, left - 100), left + width + 100)
    reads = []
    for rec in bam.fetch(tid, max(0, left - 1), left + width):
        if rec.flag & FLAG_UNMAP:
            continue
        if rec.mapq < min_mapq:
            continue
        bss = get_bsstrand(rs, rec, 20, 0)
        reads.append(ReadRow(rec, bss))
    ref_line = "".join(rs.getbase_upcase(left + i) for i in range(width))
    rows = _layout(reads)
    grid = []
    for row in rows:
        cells: List = [(" ", 0)] * width
        for r in row:
            ra = _read_attr(r.rec, color_for, hl_name)
            if show:
                txt = (r.rec.qname if show == 2
                       else _short_format(hdr, r.rec))
                col0 = max(r.rec.pos + 1 - left, 0)
                for k, ch in enumerate(txt):
                    if 0 <= col0 + k < width:
                        cells[col0 + k] = (ch, ra)
                continue
            for col, ch, attr in _render_read(r, left, width, rs,
                                              color_for, is_dot, ra):
                cells[col] = (ch, attr)
        grid.append(cells)
    return ref_line, grid


def _attr_char(a: int) -> str:
    if a == 0:
        return "."
    pair = a & 15
    if a & A_UNDER:
        return "ABCDEFGHIJ"[pair]
    return str(pair)


def dump_view(bam, rs, hdr, tid, left, width, color_for=TV_COLOR_BSMODE,
              show_attrs=False, hl_name=None, out=sys.stdout):
    ref_line, grid = _window(bam, rs, hdr, tid, left, width,
                             color_for=color_for, hl_name=hl_name)
    out.write(f"{hdr.names[tid]}:{left}-{left + width - 1}\n")
    out.write(ref_line + "\n")
    if show_attrs:
        out.write("".join(_attr_char(a)
                          for a in _ref_attrs(ref_line, color_for)) + "\n")
    for cells in grid:
        out.write("".join(c[0] for c in cells).rstrip() + "\n")
        if show_attrs:
            out.write("".join(_attr_char(a) if ch != " " else "."
                              for ch, a in cells).rstrip(".") + "\n")


HELP_LINES = [
    "        -=-    Help    -=- ",
    "",
    "?          This window",
    "Arrows     Small scroll movement",
    "space      Scroll one screen",
    "backspace  Scroll back one screen",
    "g          Go to specific location",
    "t          Color for bisulfite mode",
    "m          Color for mapping qual",
    "b          Color for base quality",
    "n          Color for nucleotide",
    ".          Toggle on/off dot view",
    "s          Toggle on/off rd brief",
    "r          Toggle on/off rd name",
    "v          Inverse video",
    "q          Exit",
    "",
    "Bisulfite Mode:",
    "Blue:     Conversion;",
    "Red:      Retention;",
    "Yellow:   Other mismatches",
    "",
    "Underline:      Secondary or orphan",
]


def curses_view(bam, rs, hdr, tid, pos, hl_name=None):
    import curses

    def init_colors(inverse):
        """tview.c:136-158: normal = colored background, inverse = colored
        foreground on default background."""
        if inverse:
            fg = [curses.COLOR_BLUE, curses.COLOR_GREEN,
                  curses.COLOR_YELLOW, curses.COLOR_WHITE,
                  curses.COLOR_GREEN, curses.COLOR_CYAN,
                  curses.COLOR_MAGENTA, curses.COLOR_RED, curses.COLOR_BLUE]
            for i, c in enumerate(fg):
                curses.init_pair(i + 1, c, -1)
        else:
            spec = [(curses.COLOR_WHITE, curses.COLOR_BLUE),
                    (curses.COLOR_BLACK, curses.COLOR_GREEN),
                    (curses.COLOR_BLACK, curses.COLOR_YELLOW),
                    (curses.COLOR_BLACK, curses.COLOR_WHITE),
                    (curses.COLOR_BLACK, curses.COLOR_GREEN),
                    (curses.COLOR_BLACK, curses.COLOR_CYAN),
                    (curses.COLOR_WHITE, curses.COLOR_MAGENTA),
                    (curses.COLOR_WHITE, curses.COLOR_RED),
                    (curses.COLOR_WHITE, curses.COLOR_BLUE)]
            for i, (f, b) in enumerate(spec):
                curses.init_pair(i + 1, f, b)

    def cattr(a: int) -> int:
        x = curses.color_pair(a & 15) if (a & 15) else 0
        if a & A_UNDER:
            x |= curses.A_UNDERLINE
        if a & A_REV:
            x |= curses.A_REVERSE
        return x

    def show_help(scr):
        h, w = scr.getmaxyx()
        wh = min(len(HELP_LINES) + 4, h)
        ww = min(44, w)
        win = curses.newwin(wh, ww, max(0, (h - wh) // 2),
                            max(0, (w - ww) // 2))
        win.border("|", "|", "-", "-", "+", "+", "+", "+")
        for i, line in enumerate(HELP_LINES[:wh - 3]):
            try:
                win.addstr(i + 1, 2, line[:ww - 4])
            except curses.error:
                pass
        win.refresh()
        win.getch()
        del win

    def main(scr):
        curses.start_color()
        curses.use_default_colors()
        inverse = True          # tview.c:209: default inverse video
        init_colors(inverse)
        left = pos
        t = tid
        msg = ""
        color_for = TV_COLOR_BSMODE
        is_dot = True
        show = 0
        row_shift = 0
        while True:
            h, w = scr.getmaxyx()
            width = w - 1
            scr.erase()
            ref_line, grid = _window(bam, rs, hdr, t, left, width,
                                     color_for=color_for, is_dot=is_dot,
                                     hl_name=hl_name, show=show)
            # coordinate ruler (tview.c:454-459)
            for i in range(1, width - 9):
                p = left + i
                if p % 20 == 0:
                    try:
                        scr.addstr(0, i - 1, f"|{p}")
                    except curses.error:
                        pass
            rattrs = _ref_attrs(ref_line, color_for)
            for i, c in enumerate(ref_line[:width]):
                try:
                    scr.addch(1, i, c, cattr(rattrs[i]))
                except curses.error:
                    pass
            for i, cells in enumerate(grid[row_shift:row_shift + h - 3]):
                for col, (ch, a) in enumerate(cells):
                    if ch != " ":
                        try:
                            scr.addch(i + 2, col, ch, cattr(a))
                        except curses.error:
                            pass
            if msg:
                try:
                    scr.addstr(h - 1, 0, msg[:width])
                except curses.error:
                    pass
            scr.refresh()
            c = scr.getch()
            if c in (ord("q"), 27):
                break
            elif c == ord("?"):
                show_help(scr)
            elif c in (ord("g"), ord("/")):
                curses.echo()
                scr.addstr(h - 1, 0, "goto: ")
                s = scr.getstr(h - 1, 6, 40).decode()
                curses.noecho()
                try:
                    if ":" in s:
                        name, p = s.split(":")
                        t2 = hdr.name2tid(name)
                        if t2 >= 0:
                            t = t2
                            left = max(1, int(p.replace(",", "")))
                    else:
                        left = max(1, int(s.replace(",", "")))
                    msg = ""
                except ValueError:
                    msg = f"bad region {s}"
            elif c == ord("t"):
                color_for = TV_COLOR_BSMODE
            elif c == ord("m"):
                color_for = TV_COLOR_MAPQ
            elif c == ord("b"):
                color_for = TV_COLOR_BASEQ
            elif c == ord("n"):
                color_for = TV_COLOR_NUCL
            elif c == ord("v"):
                inverse = not inverse
                init_colors(inverse)
            elif c == ord("s"):
                show = 0 if show == 1 else 1
            elif c == ord("r"):
                show = 0 if show == 2 else 2
            elif c == ord("."):
                is_dot = not is_dot
            elif c in (ord("l"), curses.KEY_RIGHT):
                left += 1
            elif c in (ord("h"), curses.KEY_LEFT):
                left = max(1, left - 1)
            elif c == ord("L"):
                left += 20
            elif c == ord("H"):
                left = max(1, left - 20)
            elif c == 0x0c:            # ctrl-L: 1k right
                left += 1000
            elif c == 0x08:            # ctrl-H: 1k left
                left = max(1, left - 1000)
            elif c == ord(" "):
                left += width
            elif c in (curses.KEY_BACKSPACE, 0x7f):
                left = max(1, left - width)
            elif c in (ord("j"), curses.KEY_UP):
                row_shift = max(0, row_shift - 1)
            elif c in (ord("k"), curses.KEY_DOWN):
                row_shift += 1
            elif c == curses.KEY_PPAGE:
                row_shift = max(0, row_shift - 10)
            elif c == curses.KEY_NPAGE:
                row_shift += 10

    import curses
    curses.wrapper(main)


def usage(out=sys.stderr):
    out.write("\nUsage: biscuit tview [options] <in.bam> <ref.fa>\n\n")
    out.write("Options:\n")
    out.write("    -g STR    Go directly to this position\n")
    out.write("    -m INT    Max number of reads to load per position [50]\n")
    out.write("    -n STR    Highlight the read(s) with STR as the read name\n")
    out.write("    -f INT    Flanking sequence length [100]\n")
    out.write("    -d        Non-interactive dump of the first window\n")
    out.write("    -w INT    Dump window width [80]\n")
    out.write("    -c CHR    Dump color mode: t/m/b/n (emits attr lines)\n")
    out.write("    -h        This help\n\n")


COLOR_BY_KEY = {"t": TV_COLOR_BSMODE, "m": TV_COLOR_MAPQ,
                "b": TV_COLOR_BASEQ, "n": TV_COLOR_NUCL}


def main(argv):
    reg = None
    dump = False
    width = 80
    hl_name = None
    color_for = TV_COLOR_BSMODE
    show_attrs = False
    opts, args = getopt.getopt(argv, "g:m:n:f:dw:c:h")
    for o, a in opts:
        if o == "-g":
            reg = a
        elif o == "-m":
            pass              # max reads per pos: loader keeps all (no cap)
        elif o == "-n":
            hl_name = a
        elif o == "-f":
            pass              # flank handled by RefCache fetch margin
        elif o == "-d":
            dump = True
        elif o == "-w":
            width = int(a)
        elif o == "-c":
            if a not in COLOR_BY_KEY:
                usage()
                return 1
            color_for = COLOR_BY_KEY[a]
            show_attrs = True
        elif o == "-h":
            usage()
            return 1
    if len(args) < 2:
        usage()
        print("Please provide input bam and reference.", file=sys.stderr)
        return 1
    # reference order: <in.bam> <ref.fa> (tview.c:728-729); accept the
    # historical <ref.fa> <in.bam> too (sniffed by suffix)
    bam_fn, ref_fn = args[0], args[1]
    if bam_fn.endswith((".fa", ".fasta", ".fa.gz")) \
            or ref_fn.endswith(".bam"):
        bam_fn, ref_fn = ref_fn, bam_fn
    rs = RefCache(ref_fn)
    bam = AlignmentFile(bam_fn)
    hdr = bam.header
    tid, pos = 0, 1
    if reg:
        if ":" in reg:
            name, p = reg.split(":", 1)
            tid = hdr.name2tid(name)
            pos = max(1, int(p.split("-")[0].replace(",", "")))
        else:
            tid = hdr.name2tid(reg)
    if tid < 0:
        print(f"Unknown contig in region {reg}", file=sys.stderr)
        return 1
    if dump or not sys.stdout.isatty():
        dump_view(bam, rs, hdr, tid, pos, width, color_for=color_for,
                  show_attrs=show_attrs, hl_name=hl_name)
        return 0
    curses_view(bam, rs, hdr, tid, pos, hl_name=hl_name)
    return 0
