"""Objects a second through ``Collection.batch_put`` in set-up, batches
of 1,000 (host clock)."""


def read(run):
    return run.rows / run.import_s
