"""Message-passing operators: segment sums, the sorted bond layout and the
CUDA kernel wrappers."""
