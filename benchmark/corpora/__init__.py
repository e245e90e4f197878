"""Corpus generators, one file a kind, found by a configuration's
``corpus`` key: ``make(cfg, seed)`` returns ``(tokens, offsets, keys,
counts)``: int32 vocabulary indices, flat; int64 sentence offsets; the
vocabulary's uint64 keys and int64 counts, ordered by count descending
and key ascending, as the program orders a vocabulary."""
