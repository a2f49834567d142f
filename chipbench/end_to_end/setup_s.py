"""setup_s: seconds from the process's start to the window's first
request: imports, the kernel library's load (its build on a checkout's
first run), the plan, the cold request and the warm-up."""


def read(ctx):
    return ctx["window_start_wall"] - ctx["start_wall"]
