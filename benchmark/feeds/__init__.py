"""Batch feeds, one file a kind, found by a traffic mix's ``batcher``
key: ``Feed(tokens, offsets, vocab, cfg, mix, seed)`` with ``take(n,
record)``, ``until(seconds)`` (each a batch source for one ``train``
call, counting its ``words``) and ``close()``."""
