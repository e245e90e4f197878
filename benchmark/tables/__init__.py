"""The program's table state, read and written through one file a
transfer (found by a traffic mix's ``transfer`` key), so that a
transfer whose state is laid out otherwise (sharded, say) adds a file:
``slots(model, keys)``, ``capacity(model)``, ``write_rows(model, field,
slots, rows)``, ``zero(model, field)``, ``touched(model, field)`` (the
slots where ``field`` is not zero) and ``read_rows(model, field,
slots)``, the rows as float32 on the host.  Slots are the program's
row addresses of the vocabulary's keys."""
