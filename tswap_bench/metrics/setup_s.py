"""setup_s: seconds from the process's start to the window's opening:
interpreter and library start-up, the CUDA context, the kernel library's
load (its build, in a checkout's first run), the grid and the solves'
inputs, and the warm-up solve's prepare and steps."""


def read(win):
    return win.setup_s
