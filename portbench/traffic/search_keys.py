"""Traffic kind ``search_keys``: the Graph500 run.

The configuration's search keys in an order drawn from the run's seed,
cycled, one ``CompiledBFS.bfs`` call a search, each timed alone and ended by
a device synchronisation, as the specification times them.  A mix of this
kind gives the searches made in set-up (``warmup_searches``).
"""
import torch

ORDER_STREAM = 0x6F726472


def key_order(n_keys: int, seed: int) -> list:
    """The key indices in the order the window searches them, cycled."""
    gen = torch.Generator().manual_seed(int(seed) ^ ORDER_STREAM)
    return torch.randperm(n_keys, generator=gen).tolist()


def warm(prog, mix, seed):
    order = key_order(len(prog.roots), seed)
    for i in range(mix["warmup_searches"]):
        prog.compiled.bfs(prog.roots[order[i % len(order)]])


def window(prog, mix, seed, rec):
    order = key_order(len(prog.roots), seed)
    i = 0
    while rec.more():
        k = order[i % len(order)]
        rec.call([k], lambda: [prog.compiled.bfs(prog.roots[k])])
        i += 1
