"""bu_read_share.bfs: the row entries the bottom-up levels' relax read
(the program's counter ``bfs.bu_entries_read``) over their unvisited
adjacency (``bfs.bu_entries_unvisited``, the entries a relax of every
unvisited vertex's whole row reads), in percent, over the traced window;
none for a program without those counters or a window without a bottom-up
level."""


def read(ctx):
    if ctx.kernel != "bfs":
        return None
    entries = ctx.counters.get("bfs.bu_entries_read")
    unvisited = ctx.counters.get("bfs.bu_entries_unvisited")
    if entries is None or not unvisited:
        return None
    return 100.0 * entries / unvisited
