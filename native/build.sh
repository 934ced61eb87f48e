#!/bin/sh
# Build the native helpers next to this script (plain names, for manual
# use).  The Python bindings build their own content-addressed copies
# (lib<stem>.<sha8>.so) on demand — see ca_lanczos_tpu/utils/_native_build.py.
set -e
cd "$(dirname "$0")"
g++ -O2 -shared -fPIC -o libmmio.so mmio.cpp
g++ -O3 -fopenmp -shared -fPIC -o libspmm.so spmm.cpp
echo "built $(pwd)/libmmio.so $(pwd)/libspmm.so"
