"""The FASTQ batch reads (the reader thread) and the SAM text out, in
seconds from the harness's spans, over the window, in percent."""


def read(ctx):
    return 100.0 * (ctx["spans"]["read"] + ctx["spans"]["write"]) / ctx["wall"]
