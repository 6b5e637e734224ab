"""plain_grad_rows_per_step: the indices, in one training step, whose
gradient-carrying gather stayed on plain indexing (its transpose on
autograd's `index_put_`), the growth of `ops.gather.plain_grad_rows`
over one step after the window (kind `train_tree`)."""


def read(record):
    return record.get("plain_grad_rows")
