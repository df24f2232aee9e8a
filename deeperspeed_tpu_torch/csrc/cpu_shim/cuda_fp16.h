// CPU shim stand-in for <cuda_fp16.h>
#pragma once
#include "cuda_shim.h"
