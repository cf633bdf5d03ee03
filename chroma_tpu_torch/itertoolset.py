"""Iterator helpers (reference: chroma/itertoolset.py)."""
from __future__ import annotations

import itertools
from itertools import chain, cycle, islice, repeat  # noqa: F401  (re-export)


def peek(iterable):
    """Return (first_element, restored_iterator)."""
    it = iter(iterable)
    first = next(it)
    return first, chain([first], it)


def take(n, iterable):
    """First n items of the iterable as a list."""
    return list(islice(iterable, n))


def roundrobin(*iterables):
    "roundrobin('ABC', 'D', 'EF') --> A D E B F C"
    num_active = len(iterables)
    nexts = cycle(iter(it).__next__ for it in iterables)
    while num_active:
        try:
            for nxt in nexts:
                yield nxt()
        except StopIteration:
            num_active -= 1
            nexts = cycle(islice(nexts, num_active))


def flatten(listOfLists):
    "Flatten one level of nesting."
    return chain.from_iterable(listOfLists)


def repeat_func(func, times=None, *args):
    "Repeat calls to func with specified arguments."
    if times is None:
        return itertools.starmap(func, repeat(args))
    return itertools.starmap(func, repeat(args, times))


def grouper(n, iterable, fillvalue=None):
    "grouper(3, 'ABCDEFG', 'x') --> ABC DEF Gxx"
    args = [iter(iterable)] * n
    return itertools.zip_longest(fillvalue=fillvalue, *args)


def product(*args, **kwds):
    return itertools.product(*args, **kwds)
