"""Statistical primitives for genotyping.

The reference gets these from the external huishenlab/utils stats.h
(genotype_lnlik, somatic_posterior, pval2qual, ln_sum3; see
src/pileup.c:393-409,509 for call sites), which is fetched at
build time and is NOT mirrored in the reference checkout. The formulas below
are re-derived from the call-site semantics and the BISCUIT paper's model
(binomial allele-count likelihoods with sequencing error + contamination);
they are this framework's defined behavior.

Copy of biscuit_tpu/pileup/stats.py: the code is the source's, so that the port
imports nothing of the JAX package; tests/test_torch_engine.py holds the
copy to its source.
"""
import math

HOMOREF, HET, HOMOVAR = 0, 1, 2


def genotype_lnlik(genotype: int, cref: int, altsupp: int, error: float,
                   contam: float) -> float:
    """ln P(data | genotype): binomial with alt-read probability per
    genotype; contamination adds reference reads to non-ref genotypes and
    alt reads to hom-ref."""
    if genotype == HOMOREF:
        p_alt = error + contam
    elif genotype == HET:
        p_alt = 0.5
    else:  # HOMOVAR
        p_alt = 1.0 - error - contam
    p_alt = min(max(p_alt, 1e-12), 1 - 1e-12)
    return cref * math.log(1.0 - p_alt) + altsupp * math.log(p_alt)


def ln_sum3(a: float, b: float, c: float) -> float:
    m = max(a, b, c)
    return m + math.log(math.exp(a - m) + math.exp(b - m) + math.exp(c - m))


def pval2qual(p: float) -> float:
    """Phred-scale a probability; caps extreme values."""
    if p <= 0.0:
        return 255.0
    q = -10.0 * math.log10(p)
    return max(q, 0.0)


def somatic_posterior(cref_t: int, altcnt_t: int, cref_n: int, altcnt_n: int,
                      error: float, mu: float, mu_somatic: float,
                      contam: float) -> float:
    """Probability that the tumor's alt support is NOT a somatic event
    (phred-scaled by the caller via pval2qual). Model: compare
      somatic:   tumor HET-like alt fraction, normal hom-ref
      germline:  both samples share the variant
      wildtype:  both hom-ref (errors only)
    with priors mu_somatic / mu / (remainder)."""
    ln_som = (genotype_lnlik(HET, cref_t, altcnt_t, error, contam)
              + genotype_lnlik(HOMOREF, cref_n, altcnt_n, error, contam)
              + math.log(max(mu_somatic, 1e-300)))
    ln_germ = (genotype_lnlik(HET, cref_t, altcnt_t, error, contam)
               + genotype_lnlik(HET, cref_n, altcnt_n, error, contam)
               + math.log(max(mu, 1e-300)))
    ln_wild = (genotype_lnlik(HOMOREF, cref_t, altcnt_t, error, contam)
               + genotype_lnlik(HOMOREF, cref_n, altcnt_n, error, contam)
               + math.log(max(1.0 - mu - mu_somatic, 1e-300)))
    total = ln_sum3(ln_som, ln_germ, ln_wild)
    p_not_somatic = 1.0 - math.exp(ln_som - total)
    return max(p_not_somatic, 0.0)


def fisher_exact(n11: int, n12: int, n21: int, n22: int) -> float:
    """Two-sided Fisher exact test p-value for a 2x2 table."""
    def lchoose(n, k):
        return math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1)

    r1, r2 = n11 + n12, n21 + n22
    c1 = n11 + n21
    n = r1 + r2

    def lp(k):
        return lchoose(r1, k) + lchoose(r2, c1 - k) - lchoose(n, c1)

    lo = max(0, c1 - r2)
    hi = min(c1, r1)
    p_obs = lp(n11)
    total = 0.0
    for k in range(lo, hi + 1):
        v = lp(k)
        if v <= p_obs + 1e-12:
            total += math.exp(v)
    return min(total, 1.0)


def two_by_two_chisq(n11: float, n12: float, n21: float, n22: float) -> float:
    """Chi-square statistic for a 2x2 table (no continuity correction)."""
    n = n11 + n12 + n21 + n22
    if n == 0:
        return 0.0
    r1, r2 = n11 + n12, n21 + n22
    c1, c2 = n11 + n21, n12 + n22
    if not (r1 and r2 and c1 and c2):
        return 0.0
    stat = 0.0
    for obs, er, ec in ((n11, r1, c1), (n12, r1, c2), (n21, r2, c1), (n22, r2, c2)):
        e = er * ec / n
        stat += (obs - e) ** 2 / e
    return stat


def chisq_sf_1df(x: float) -> float:
    """Survival function of chi-square with 1 df (gsl_cdf_chisq_Q(x, 1))."""
    if x <= 0:
        return 1.0
    return math.erfc(math.sqrt(x / 2.0))
