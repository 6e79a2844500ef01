"""The Tensor-method binding table (the port's own copy of
``paddle_tpu/core/tensor_method_table.py``).

``paddle_tpu_torch/__init__.py`` binds a name of this table onto
``torch.Tensor`` only where torch has no attribute of that name and the
package defines the function; an attribute torch already has is never
replaced, since that would change torch for every caller in the process.
"""

TENSOR_METHOD_FUNC = (
    "abs", "abs_", "acos", "acos_", "acosh", "acosh_", "add", "add_",
    "add_n", "addmm", "addmm_", "all", "allclose", "amax", "amin", "angle",
    "any", "argmax", "argmin", "argsort", "as_complex", "as_real",
    "as_strided", "asin", "asin_", "asinh", "asinh_", "atan", "atan2",
    "atan_", "atanh", "atanh_", "atleast_1d", "atleast_2d", "atleast_3d",
    "bernoulli_", "bincount", "bitwise_and", "bitwise_and_",
    "bitwise_left_shift", "bitwise_left_shift_", "bitwise_not",
    "bitwise_not_", "bitwise_or", "bitwise_or_", "bitwise_right_shift",
    "bitwise_right_shift_", "bitwise_xor", "bitwise_xor_", "block_diag",
    "bmm", "broadcast_shape", "broadcast_tensors", "broadcast_to",
    "bucketize", "cast", "cast_", "cauchy_", "cdist", "ceil", "ceil_",
    "cholesky", "cholesky_inverse", "cholesky_solve", "chunk", "clip",
    "clip_", "combinations", "concat", "cond", "conj", "copysign",
    "copysign_", "corrcoef", "cos", "cos_", "cosh", "cosh_", "count_nonzero",
    "cov", "create_parameter", "create_tensor", "cross", "cummax", "cummin",
    "cumprod", "cumprod_", "cumsum", "cumsum_", "cumulative_trapezoid",
    "deg2rad", "diag", "diag_embed", "diagflat", "diagonal",
    "diagonal_scatter", "diff", "digamma", "digamma_", "dist", "divide",
    "divide_", "dot", "dsplit", "eig", "eigvals", "eigvalsh", "equal",
    "equal_", "equal_all", "erf", "erfinv", "erfinv_", "exp", "exp_",
    "expand", "expand_as", "expm1", "exponential_", "flatten", "flatten_",
    "flip", "floor", "floor_", "floor_divide", "floor_divide_", "floor_mod",
    "floor_mod_", "fmax", "fmin", "frac", "frac_", "frexp", "gammainc",
    "gammainc_", "gammaincc", "gammaincc_", "gammaln", "gammaln_", "gather",
    "gather_nd", "gcd", "gcd_", "geometric_", "greater_equal",
    "greater_equal_", "greater_than", "greater_than_", "heaviside",
    "histogram", "histogram_bin_edges", "histogramdd", "householder_product",
    "hsplit", "hypot", "hypot_", "i0", "i0_", "i0e", "i1", "i1e", "imag",
    "increment", "index_add", "index_add_", "index_fill", "index_fill_",
    "index_put", "index_put_", "index_sample", "index_select", "inner",
    "inverse", "is_complex", "is_empty", "is_floating_point", "is_integer",
    "is_tensor", "isclose", "isfinite", "isin", "isinf", "isnan", "isneginf",
    "isposinf", "isreal", "istft", "kron", "kthvalue", "lcm", "lcm_",
    "ldexp", "ldexp_", "lerp", "lerp_", "less_equal", "less_equal_",
    "less_than", "less_than_", "lgamma", "lgamma_", "log", "log10", "log10_",
    "log1p", "log1p_", "log2", "log2_", "log_", "log_normal_", "logaddexp",
    "logcumsumexp", "logical_and", "logical_and_", "logical_not",
    "logical_not_", "logical_or", "logical_or_", "logical_xor",
    "logical_xor_", "logit", "logit_", "logsumexp", "lstsq", "lu",
    "lu_unpack", "masked_fill", "masked_fill_", "masked_scatter",
    "masked_scatter_", "masked_select", "matmul", "matrix_power", "max",
    "maximum", "mean", "median", "min", "minimum", "mm", "mod", "mod_",
    "mode", "moveaxis", "multi_dot", "multigammaln", "multigammaln_",
    "multinomial", "multiplex", "multiply", "multiply_", "mv", "nan_to_num",
    "nan_to_num_", "nanmean", "nanmedian", "nanquantile", "nansum", "neg",
    "neg_", "nextafter", "nonzero", "norm", "normal_", "not_equal",
    "not_equal_", "numel", "ormqr", "outer", "pca_lowrank", "pinv", "polar",
    "polygamma", "polygamma_", "pow", "pow_", "prod", "put_along_axis",
    "put_along_axis_", "qr", "quantile", "rad2deg", "rank", "real",
    "reciprocal", "reciprocal_", "reduce_as", "remainder", "remainder_",
    "renorm", "renorm_", "repeat_interleave", "reshape", "reshape_",
    "reverse", "roll", "rot90", "round", "round_", "rsqrt", "rsqrt_",
    "scale", "scale_", "scatter", "scatter_", "scatter_nd", "scatter_nd_add",
    "select_scatter", "sgn", "shape", "shard_index", "sigmoid", "sigmoid_",
    "sign", "signbit", "sin", "sin_", "sinc", "sinc_", "sinh", "sinh_",
    "slice", "slice_scatter", "solve", "sort", "split", "sqrt", "sqrt_",
    "square", "squeeze", "squeeze_", "stack", "stanh", "std", "stft",
    "strided_slice", "subtract", "subtract_", "sum", "svd_lowrank", "t",
    "t_", "take", "take_along_axis", "tan", "tan_", "tanh", "tanh_",
    "tensor_split", "tensordot", "tile", "top_p_sampling", "topk", "trace",
    "transpose", "transpose_", "trapezoid", "triangular_solve", "tril",
    "tril_", "triu", "triu_", "trunc", "trunc_", "unbind", "unflatten",
    "unfold", "uniform_", "unique", "unique_consecutive", "unsqueeze",
    "unsqueeze_", "unstack", "vander", "var", "view", "view_as", "vsplit",
    "where", "where_",
)

# Names that ``torch.Tensor`` already has, so they stay torch's methods,
# while the flat function of the same name (``paddle_tpu_torch.<name>``)
# carries Paddle's meaning and gives another result.  By kind:
_SIGNATURE = (  # the arguments mean other things
    "transpose", "gather", "scatter", "scatter_", "split", "chunk",
    "index_select", "where", "unsqueeze", "flatten", "view", "t", "t_",
    "prod", "quantile",
)
_RESULT = (  # another result or result structure for the same call
    "max", "min", "sort", "median", "topk", "argsort", "unique", "nonzero",
    "numel", "equal", "allclose", "cumsum", "cumprod", "cummax", "cummin",
    "logsumexp",
)
_DTYPE = (  # jax.numpy's promotion against torch's (or torch refuses)
    "add", "subtract", "multiply", "divide", "pow", "remainder",
    "floor_divide", "maximum", "minimum", "fmax", "fmin", "logaddexp",
    "atan2", "isclose", "exp", "expm1", "log", "log2", "log10", "log1p",
    "sqrt", "rsqrt", "reciprocal", "sin", "cos", "tan", "asin", "acos",
    "atan", "sinh", "cosh", "asinh", "acosh", "atanh", "erf", "erfinv",
    "lgamma", "digamma", "i0", "sigmoid", "tanh", "frac", "mean", "var",
    "std", "nanmean", "clip", "lerp", "masked_fill", "matmul",
)
_INPLACE = (  # torch keeps x's dtype (or raises); Paddle's takes the result's
    "abs_", "acos_", "acosh_", "add_", "asin_", "asinh_", "atan_",
    "atanh_", "bitwise_and_", "bitwise_not_", "bitwise_or_",
    "bitwise_xor_", "ceil_", "clip_", "cos_", "cosh_", "cumprod_",
    "cumsum_", "digamma_", "divide_", "erfinv_", "exp_", "floor_",
    "floor_divide_", "frac_", "gcd_", "greater_equal_", "i0_", "lcm_",
    "lerp_", "less_equal_", "lgamma_", "log10_", "log1p_", "log2_", "log_",
    "logical_and_", "logical_not_", "logical_or_", "logical_xor_",
    "masked_fill_", "multiply_", "nan_to_num_", "neg_", "not_equal_",
    "pow_", "reciprocal_", "remainder_", "rsqrt_", "sigmoid_", "sin_",
    "sinh_", "sqrt_", "squeeze_", "subtract_", "tan_", "tanh_", "tril_",
    "triu_", "trunc_", "unsqueeze_", "transpose_",
)
_GENERATOR = (  # torch's methods draw from torch's global generator
    "bernoulli_", "cauchy_", "exponential_", "geometric_", "log_normal_",
    "normal_", "uniform_", "multinomial",
)

TORCH_MEANING_DIFFERS = {
    **{n: "signature" for n in _SIGNATURE},
    **{n: "result" for n in _RESULT},
    **{n: "dtype" for n in _DTYPE},
    **{n: "in place" for n in _INPLACE},
    **{n: "generator" for n in _GENERATOR},
}
