"""Fixture: generation-pinning violations (never imported — parsed only)."""


def tearing_batch(store, ids):
    slots = store.generation.state.slot_of[ids]     # gen-chained-read
    table = store.generation.table                  # gen-chained-read (+2nd
    return slots, table                             # read: gen-multi-read)


def peek_buffers(store):
    return store._shadow is not None                # gen-direct-private


def pinned_batch(store, ids):
    gen = store.generation                          # single snapshot: clean
    return gen.state.slot_of[ids], gen.table
