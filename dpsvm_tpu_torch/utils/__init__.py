"""Utilities of the port: input coercion (copy of ``dpsvm_tpu.utils.densify``)."""


def densify(x):
    """scipy.sparse input -> dense ndarray; anything else passes through.

    The compute path is dense (kernel rows are products over a dense X),
    and ``np.asarray`` on a sparse matrix gives a 0-d object array, so
    every entry point densifies first."""
    if hasattr(x, "toarray") and hasattr(x, "tocsr"):
        return x.toarray()
    return x


__all__ = ["densify"]
