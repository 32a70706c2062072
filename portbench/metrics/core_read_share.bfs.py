"""core_read_share.bfs: the words of the dense core that the bottom-up
levels' ``core_spmv`` launches read (the program's counter
``bfs.core_words_read``: each row up to the group of its first frontier
hit, all of it when none hits) over the core's words times those launches
(``bfs.core_words``), in percent, over the traced window; none for a program
without those counters or a window without a core launch."""


def read(ctx):
    if ctx.kernel != "bfs":
        return None
    read_words = ctx.counters.get("bfs.core_words_read")
    words = ctx.counters.get("bfs.core_words")
    if read_words is None or not words:
        return None
    return 100.0 * read_words / words
