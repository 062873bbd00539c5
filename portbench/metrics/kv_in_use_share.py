"""kv_in_use_share (%): the mean share of the paged pool's pages that
requests hold after each of the window's iterations (the pool is what
``kv_budget_tokens`` reserves); None without a paged pool."""


def read(rec):
    if not rec.kv_pool_pages:
        return None
    kv = [it.kv_pages for it in rec.iters if it.kv_pages is not None
          and rec.in_window(it.t0, it.t1)]
    if not kv:
        return None
    return 100.0 * sum(kv) / len(kv) / rec.kv_pool_pages
