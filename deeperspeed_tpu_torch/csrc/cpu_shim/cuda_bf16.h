// CPU shim stand-in for <cuda_bf16.h>
#pragma once
#include "cuda_shim.h"
