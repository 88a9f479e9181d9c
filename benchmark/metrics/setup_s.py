"""setup_s: process start until the window opens (imports, the kernels
loaded or built, the weights made from the seed, the text context, the
warm-up request or requests)."""


def read(record):
    return record["setup_s"]
