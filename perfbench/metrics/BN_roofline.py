"""The masked BN kernels' least time for the traced sub-window's
buildings over their device time there (every kernel labelled BN: the
statistics, fold and normalise passes forward, the sums, fold and dx
passes backward), %: the least time of each site the family counts
(``bn_sites`` of its building_work) is its bytes (counts.bn_bytes: each
pass over its valid rows once) over the memory bandwidth. None where the
family counts no sites or BN ran for no time. It serves every metric
``BN_roofline.<part>``."""

from perfbench.counts import bn_bytes


def read(run):
    s = run.sub
    if s is None or run.peaks is None or not s["kernel_s"].get("BN"):
        return None
    sites = [site for b in run.window["sub_buildings"]
             for site in run.work[b].get("bn_sites", ())]
    if not sites:
        return None
    least = bn_bytes(sites, run.esize) / run.peaks["hbm"]
    return 100.0 * least / s["kernel_s"]["BN"]
